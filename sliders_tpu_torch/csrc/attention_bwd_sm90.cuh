// The Hopper mainloop of the attention backwards: kernel #2's exact softmax
// backward (sd_attention_bwd.cu, every d its gate takes in bf16 and f32, and
// d = 40, 64, 80 and 128 in f16) and
// kernel #4's flash backward in bf16 at d = 128 and 256 and in f32 at d =
// 128, 256 and 512 (flash_attention.cu). It takes the ring's fill and the descriptors of
// attention_sm90.cuh, and the PTX wrappers of sm90_ptx.cuh. Its TF32 pieces
// (the split pass at the end of this file, the in-kernel splits, the
// three-product step tf32x3) also serve #1's f32 forward (sd_attention.cu).
//
// Both backwards compute the same five products per pair of a q tile and a
// K/V tile: S = Q.K^T, dP = dO.V^T, dV += P^T.dO, dK += dS^T.Q, dQ += dS.K.
// Two kernels per backward, no atomics, so the sums are the same from run
// to run:
//   - a K/V-major dk/dv kernel: a block item owns the resident K/V rows (K
//     and V loaded once into shared memory), and the producer streams
//     (Q, dO) tiles and their rows' statistics through the ring;
//   - a q-major dq kernel: a block item owns the resident q rows (Q and dO
//     loaded once), the producer streams (K, V) tiles.
// The grid is persistent (one block an SM walking items), the ring's stages
// and phases run on across items, and the fill is attention_sm90.cuh's: TMA
// with the 128-byte swizzle where a row is 128, 256 or 512 bytes, 16-byte
// cp.async with zero-fill into the no-swizzle core-matrix layout at every
// other bf16 d (f32: TMA boxes 16 bytes wide into that layout); each tile's
// row statistics come by a 1-d bulk copy. The producer
// warpgroup keeps 40 registers and the two consumers take 232
// (`setmaxnreg`). Three consumer plans share that ring (BCfg::KIND):
//
// PAIR (bf16 and, as `BCfgF16`, f16: d <= 128): 128 resident rows, each consumer warpgroup 64 of
// them and every product of its rows. Per streamed tile (64 rows, 128 for
// #2 at d <= 48) a dk/dv consumer forms S^T = K.Q^T and dP^T = V.dO^T
// (`wgmma`, both operands in shared memory, K-major), then P^T and dS^T in
// f32 registers from the statistics of the tile's columns, rounds them to
// the input dtype (bf16 or f16, the TPU kernel's rounding points at that
// dtype) straight into the A registers of dV += P^T.dO and dK += dS^T.Q
// (`wgmma` with A from registers, dO and Q read MN-major through the
// transpose flag, as #1 reads V); a dq consumer forms S and dP, dS in
// registers, dQ += dS.K with K read MN-major. What bounds it is registers:
// a dk/dv consumer holds 64 + 64 f32 accumulators at d = 128 beside the
// 32 + 32 of S^T and dP^T. Where d (padded) plus the streamed rows is at
// most 160 the softmax overlaps the products inside a warpgroup (p is formed
// while dP^T runs, ds while dV += p^T dO runs); elsewhere (d = 40, 48 and
// 104-128) that spilled or ran slower on the card, and p and ds are formed
// one k16 slice at a time after both products, each slice's share of dV and
// dK running while the next is formed.
//
// SPLIT (bf16, #4 at d = 256): dK and dV are 64 x 256 f32 accumulators, 128
// registers a thread each, so one warpgroup cannot hold both beside S^T; and
// a 64-row tile is 32 KB, so the item owns 64 resident rows (64 KB). Both
// consumers share the 64 rows and each holds one output: in the dk/dv
// kernel warpgroup 0 forms S^T, p and dV += round(p)^T dO, warpgroup 1
// dP^T, ds (with p from warpgroup 0 through shared memory, in accumulator
// order) and dK += round(ds)^T Q, over 32-row (Q, dO) tiles (a 64-column
// S^T beside the accumulator spilled 588 bytes; this one still spills 260
// and ptxas serialises its wgmmas for want of registers, C7512); in the dq
// kernel, over 64-row (K, V) tiles, warpgroup 0 forms S and p, warpgroup 1
// dP and ds, and each takes half of dQ's 256 columns (ds's bf16 A
// registers cross back, 8 KB). The four products of a tile are equal in
// size, so the two warpgroups carry equal shares; named barriers order the
// exchange (XFULL / XEMPTY, DFULL / DEMPTY). This is the schedule of the
// d = 128 kernels with S and dP formed once per tile; the kernel it
// replaces split d into 128-wide output chunks across blocks and formed S
// and dP for each.
//
// TF32 (f32: #2 at every d of its gate, 8..128, and #4 at d = 128, whose
// dq kernel reads the forward's residuals and makes no statistics pass):
// error-compensated TF32,
// as the f32 convs run (conv3x3_sm90.cuh): each product is three
// `wgmma.m64nNk8.f32.tf32.tf32` a k8 step, A_lo B_hi + A_hi B_lo + A_hi
// B_hi, with hi = x rounded to TF32 and lo = the rest (the split pass:
// tf32_rna(x - hi); in the kernel: x - hi exactly, read truncated); the
// dropped A_lo B_lo and the splits' remainders are each 2^-21 to 2^-22 of
// a product, where one TF32 product would keep about 11 bits. What shapes
// it:
//   - TF32 `wgmma` reads B from shared memory K-major only (no transpose
//     flag), so a B operand needs its hi and lo planes in shared memory,
//     K-major. The wrapper's split pass writes the hi and lo planes of q, k,
//     v and g once a call (O(L d) bytes against O(L^2 d) of work), and the
//     streamed tiles come from them (two planes a tile); the resident tiles
//     come raw and are split in registers as their A fragments load
//     (`ldmatrix` on 32-bit data gives the TF32 fragment, as in the convs).
//   - The second use of each streamed tile contracts over its rows, which
//     K-major would need transposed: instead the products are taken
//     transposed, dV^T += dO^T.P, dK^T += Q^T.dS and dQ^T += K^T.dS^T, with
//     A (dO^T, Q^T, K^T) read from the streamed hi and lo planes by 32-bit
//     shared loads in fragment order, and B (P, dS, dS^T) written by the
//     consumers as hi and lo tiles (64 x BN f32, 128-byte swizzle), K-major
//     in the accumulator's own orientation. So no transposed copy exists,
//     and the outputs' accumulators are d x 64 (m64 blocks of d, 32
//     registers each) however long L is.
//   - The tensor cores' accumulation is not f32's: over the thousands of
//     products of a long L it misses the f32 tolerance (as the f32 convs
//     found), so each streamed tile's products start from zero and the
//     tile's sum is added into a running f32 sum.
//   - Roles. dk/dv as SPLIT: warpgroup 0 S^T, p (its hi and lo tile is
//     dV^T's B, and warpgroup 1 reads p = hi + lo from it), dV^T;
//     warpgroup 1 dP^T, ds, dK^T. dq where d <= 64 (OWN): 128 resident q
//     rows, each warpgroup 64 of them and all of their products (S, dP, the
//     statistics, ds into its own dS tiles, dQ^T), so a K/V tile is read
//     once for 128 rows and nothing is exchanged: the f32 dq kernel's
//     stream of hi and lo planes, twice an item, held it (a producer that
//     copied nothing made it 31 % faster at d = 40). dq above (two stages
//     of 128 resident rows do not fit): warpgroup 0 S and p (to warpgroup 1
//     through the f32 exchange), warpgroup 1 dP, ds and dQ^T, while
//     warpgroup 0 goes on to the next tile's S; in #2's statistics pass
//     warpgroup 0 sends each tile's exps and the rescale of its rows,
//     warpgroup 1 keeps the dsum sum, and 1 / l crosses at the end. #4 (d =
//     128 only: DP = 256, so this form) reads m and l in warpgroup 0 and
//     di in warpgroup 1.
//   - Shared memory: 64 resident rows raw, stages of 2 x 2 planes of BN
//     rows, and 64 KB (BN = 64) or 32 KB (BN = 32) of exchange; BN is 64
//     where d <= 48 and 32 above, so d = 128 fits two stages in 227 KB.
//   - Issue, not the tensor cores (which run m64n64k8 TF32 from registers
//     at 470-483 TFLOP/s alone), bounds it: every tile loads by TMA (the
//     producer's 16-byte cp.async copies took a third of the dq kernel's
//     time at d = 40), and the kernel splits its own values with integer
//     operations (two cvt.rna.tf32.f32 an element held the exchange).
//
// CLUSTER (TF32 with CS = d / 128 > 1: #4 in f32 at d = 256 and 512, no
// model's path): at d = 256 the 64 resident rows alone are 128 KB, and a
// stage of 32 streamed rows' hi and lo planes another 128 KB, more than a
// block holds. So the CS blocks of a thread-block cluster split d, each
// the TF32 plan's d = 128 kernel over its columns [128 rank, + 128): the
// resident rows' and the streamed tiles' columns by its own TMA ring; the
// partial S^T and dP^T (dq: S and dP) over them, from zero, three TF32
// products a k8 step. Each consumer warpgroup sends its 64 x BN partial to
// the same warpgroup of every other block of the cluster (st.shared::cluster,
// then a remote mbarrier arrival that releases the stores), waits for
// theirs and sums the CS partials in rank order (cluster_sum), so every
// block forms the same p and ds bits. Then each block's transposed
// products make its 128 columns of dV^T and dK^T (dQ^T) from its own
// streamed columns. S and dP are formed once per tile, not once per
// 128-wide output chunk as by the FMA kernels this replaced.
//   - d = 256 (XALIAS): the d = 128 kernel's shared memory exactly (two
//     32-row stages), so the other block's partial lands in the exchange
//     tile this block overwrites next (P^T's or dS^T's lo tile; in the dq
//     kernel the f32 exchange, each thread's elements where it then writes
//     p, and dS's lo tile); after the tile's products read them, one thread
//     arrives on the other block's xfree barrier, and a block sends tile n
//     only after tile n - 1's free. (16-row tiles with receive slots of
//     their own, the first design, take twice the tiles and m64n16 S
//     products: PERF.md, section 6.)
//   - d = 512: three senders' partials need slots of their own: 16-row
//     stages, two slots a role in turn, two stages.
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
//     dk = scale (ds^T q), the scale applied after the f32 sums (round() is
//     the identity in f32).
// #2's statistics (each q row's max m, sum l and dsum) are needed by both
// of its kernels. Its dq kernel finds them in a first pass over the same
// ring, one S and dP pass with a running max (l and the dsum sum rescaled
// when the max grows, dsum = that sum / l), writes them to an f32 scratch
// for the dk/dv kernel that runs after it, and then makes its dq pass: nine
// products in all, against ten for a Q.K^T pass for m and l followed by an
// S and dP pass for dsum. The dk/dv kernel reads each row's statistics in
// the form its exps take (m log2(e), 1 / l, dd), formed once per row: by
// #2's dq kernel, and for #4 by the wrapper beside di, with the same float
// operations (1 / l correctly rounded, `__frcp_rn` here) as #4's dq kernel,
// so both kernels compute the same p.
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
// pass), against 7 L d bytes; in f32 each is three TF32 products, and the
// transposed products run m64 blocks of d, so d = 40 pays for 64 there.

#pragma once

#include "attention_sm90.cuh"

namespace sm90 {

constexpr float LOG2E = 1.4426950408889634f;

struct BwdArgs {
  const bf16* q;  // f32 tensors are passed as bf16 of twice the width (dw, strides x 2)
  const bf16* k;
  const bf16* v;
  const bf16* g;  // dO, the output's gradient
  bf16* dq;       // outputs in the input dtype (f32: cast), strides in their elements
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
  long long qb, qh, ql, kb, kh, kl, vb, vh, vl, gb, gh, gl;  // element strides (bf16 units)
  long long dqb, dqh, dql, dkb, dkh, dkl, dvb, dvh, dvl;
  float scale;
  int dw;  // a row of q, k, v, g in bf16 units: d, or 2 d in f32
  // TF32: the hi planes of q, k, v and g from the wrapper's split pass, each
  // a contiguous (B, H, L, d) f32 tensor seen as bf16 (row dw), its lo plane
  // right after it
  const bf16* hq;
  const bf16* hk;
  const bf16* hv;
  const bf16* hg;
};

enum : int { PAIR = 0, SPLIT = 1, TF32 = 2 };  // the consumer plans of the note

// named barriers between the two consumer warpgroups (0 is __syncthreads)
enum : int { XFULL = 1, XEMPTY = 2, DFULL = 3, DEMPTY = 4, WGBAR = 5 /* + the warpgroup */ };

constexpr int SMEM_MAX = 232448;  // a block's dynamic shared memory on the H100

// One kernel of a backward. Shared memory, from a 1024-byte aligned base:
// barriers (1024 bytes), the item's two resident RROWS-row tiles, STAGES
// ring stages of two BN-row tiles (TF32: each a hi and a lo plane), the
// consumers' exchange (SPLIT, TF32), then the stages' statistics (dk/dv
// only). DP is a row's bytes / 2: d rounded up to 16 in bf16, 2 d in f32.
template <int DP_, int BN_, bool TMA_, bool DKV_, bool SD_, int KIND_ = PAIR, int CS_ = 1>
struct BCfg {
  static constexpr int DP = DP_;
  static constexpr int BN = BN_;      // rows of a streamed tile: q rows (dk/dv) or keys (dq)
  static constexpr int BK = BN_;      // the name attention_sm90.cuh's helpers read
  static constexpr bool TMA = TMA_;   // TMA with the 128-byte swizzle (64-column boxes)
  // TF32 otherwise TMA with 16-byte boxes and no swizzle (an f32 row is a
  // multiple of 16 bytes at every d): tile byte (row, c16) = c16 rows 16 +
  // row 16, wgmma's no-swizzle core matrices; bf16 otherwise cp.async
  static constexpr bool TMA16 = !TMA_ && KIND_ == TF32;
  static constexpr bool CPASYNC = !TMA_ && !TMA16;
  static constexpr bool DKV = DKV_;   // the dk/dv kernel, else the dq kernel
  static constexpr bool SD = SD_;     // #2's policy, else #4's
  static constexpr int KIND = KIND_;
  // TF32 with d split across a cluster of CS blocks (#4 in f32 at d = 256
  // and 512, CLUSTER in the note): DP is a block's share of the row
  static constexpr int CS = CS_;
  // TF32's dq kernel where d <= 64: each consumer warpgroup its own 64 of 128
  // resident q rows and every product of them (no exchange), so a K/V tile
  // is read once for 128 rows
  static constexpr bool OWN = KIND == TF32 && !DKV_ && DP_ <= 128;
  static constexpr int RROWS = KIND == PAIR || OWN ? QROWS : 64;  // resident rows of an item
  static constexpr int PLANES = KIND == TF32 ? 2 : 1;      // planes of a streamed tile
  static constexpr int DPF = DP / 2;                       // TF32: the f32 head dim
  static constexpr int MB = (DPF + 63) / 64;               // TF32: m64 blocks of d
  static constexpr int PRODUCER = WG;
  static constexpr int THREADS = 2 * WG + PRODUCER;  // consumers first
  static constexpr int RES_BYTES = RROWS * DP * 2;
  static constexpr int TILE_BYTES = BN * DP * 2;
  static constexpr int STAGE_BYTES = 2 * PLANES * TILE_BYTES;
  static constexpr int STAT_BYTES = DKV ? 3 * BN * 4 : 0;  // mb, iv, dd per column
  // TF32: a 64 x BN f32 exchange tile, rows 128 bytes apart (32-column
  // boxes; at BN = 16 half of each row is used)
  static constexpr int XTILE = 64 * (BN < 32 ? 32 : BN) * 4;
  // SPLIT: p in f32 in accumulator order, and (dq) ds's bf16 A registers;
  // TF32 dk/dv: the hi and lo tiles of P^T, then of dS^T; TF32 dq: dS's hi
  // and lo tiles, then an f32 exchange in accumulator order (e and the
  // rescale a, 1 / l, or p)
  static constexpr int XBYTES =
      KIND == SPLIT ? (BN / 2) * WG * 4 + (DKV ? 0 : (BN / 16) * 4 * WG * 4)
      : KIND == TF32
          ? (DKV || OWN ? 4 * XTILE
                        : 2 * XTILE + ((BN / 2 + 2) * WG * 4 + 1023) / 1024 * 1024)
          : 0;
  // CLUSTER: a partial tile of S^T (S) or dP^T (dP), 64 x BN f32 in
  // accumulator order. At d = 256 (XALIAS) the other block's partial lands
  // in the exchange tile this block next overwrites, with a "free" barrier
  // back to the sender; at d = 512 (three senders) the partials take
  // buffers of their own: [2 slots][2 roles][CS - 1 senders]
  static constexpr bool XALIAS = CS == 2;
  static constexpr int PART_BYTES = (BN / 2) * WG * 4;
  static constexpr int RECV_BYTES = CS > 2 ? 2 * 2 * (CS - 1) * PART_BYTES : 0;
  static constexpr int FIXED =
      1024 /* align */ + 1024 /* barriers */ + 2 * RES_BYTES + XBYTES + RECV_BYTES;
  static constexpr int STAGES_FIT =
      ((KIND == PAIR ? SMEM_BUDGET : SMEM_MAX) - FIXED) / (STAGE_BYTES + STAT_BYTES);
  static constexpr int STAGES = STAGES_FIT > 4 ? 4 : STAGES_FIT;
  static constexpr int SMEM = FIXED + STAGES * (STAGE_BYTES + STAT_BYTES);
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(SMEM <= SMEM_MAX, "a block's shared memory");
  static_assert(!TMA || DP == 64 || DP == 128 || DP == 256, "TMA boxes are 64 columns");
  static_assert(BN == 32 || BN == 64 || (KIND == PAIR && BN == 128) || (CS == 4 && BN == 16),
                "S tiles are wgmma n16 (CLUSTER at d = 512), n32, n64 or n128");
  static_assert(KIND != SPLIT || (DP == 256 && BN == (DKV ? 32 : 64) && !SD),
                "SPLIT is #4 at d = 256");
  static_assert(KIND != TF32 || ((SD || DPF == 128) && DPF % 8 == 0 && DPF <= 128),
                "TF32 is #2 in f32, and #4 in f32 at d = 128 (a block's 128 columns)");
  static_assert(CS == 1 || (KIND == TF32 && !SD && TMA && DPF == 128 &&
                            ((CS == 2 && BN == 32) || (CS == 4 && BN == 16))),
                "CLUSTER is #4 in f32 at d = 256 (32-row tiles) and 512 (16-row tiles), a "
                "block's 128 columns each");
  static constexpr bool F16 = false;  // 2-byte operands are bf16
};

// PAIR on f16 operands (#2 under `precision: fp16`): `.f16` wgmma, p and ds
// rounded to f16, f16 tensor maps and stores
template <int DP_, int BN_, bool TMA_, bool DKV_>
struct BCfgF16 : BCfg<DP_, BN_, TMA_, DKV_, true> {
  static constexpr bool F16 = true;
};

struct BRing {
  uint64_t* full;
  uint64_t* empty;
  uint64_t* rfull;   // the item's resident tiles have landed
  uint64_t* rempty;  // both consumers are done with them
  uint32_t res;      // resident tile 1 (K or Q); tile 2 (V or dO) RES_BYTES on
  uint32_t stages;   // stage s at stages + s * STAGE_BYTES: tile 1 (Q or K), then tile 2 (dO
                     // or V), each PLANES planes (hi, then lo) of TILE_BYTES
  uint32_t xchg;     // the consumers' exchange (SPLIT, TF32)
  uint32_t recv;     // CLUSTER at d = 512: the other blocks' partial tiles
  uint64_t* xfull;   // CLUSTER: [2 slots][2 roles] (XALIAS: [2 roles]): the partials have landed
  uint64_t* xfree;   // XALIAS: [2 roles]: the other block may send its next partial
  uint32_t rank;     // CLUSTER: this block's rank, its columns DPF rank ..
  float* stats;      // stage s: [3][BN] floats at stats + s * 3 * BN
  unsigned char* gbase;  // the generic address of shared address sbase
  uint32_t sbase;
};

// the generic pointer of shared address `a`
template <class T>
__device__ __forceinline__ T* at(const BRing& r, uint32_t a) {
  return reinterpret_cast<T*>(r.gbase + (a - r.sbase));
}

// item w: RROWS-row tile w % n of the resident side, head (w / n) % H,
// batch w / (n H)
template <class C>
__device__ __forceinline__ Item bwd_item(const BwdArgs& p, int w) {
  const int n = ((C::DKV ? p.Lk : p.Lq) + C::RROWS - 1) / C::RROWS;
  return {(w % n) * C::RROWS, (w / n) % p.H, w / (n * p.H)};
}

template <class C>
__device__ __forceinline__ int bwd_items(const BwdArgs& p) {
  return ((C::DKV ? p.Lk : p.Lq) + C::RROWS - 1) / C::RROWS * p.H * p.B;
}

// the first item of this block and the step between its items: a block
// walks every gridDim.x-th item, a cluster (CLUSTER) every cluster_count()-th
template <class C>
__device__ __forceinline__ int first_item() {
  if constexpr (C::CS > 1)
    return cluster_id();
  else
    return blockIdx.x;
}

template <class C>
__device__ __forceinline__ int item_step() {
  if constexpr (C::CS > 1)
    return cluster_count();
  else
    return gridDim.x;
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
// mb, iv and dd, or K and V; #2's dq kernel streams K and V twice; TF32:
// the hi and lo planes of each from the split pass, always by TMA). It
// only issues copies: the statistics travel through the ring with their
// tiles, by 1-d bulk copies (TMA) on both paths.
template <class C>
__device__ __forceinline__ void bwd_produce(const BwdArgs& p, const BRing& r,
                                            const CUtensorMap* ta1, const CUtensorMap* ta2,
                                            const CUtensorMap* tb1, const CUtensorMap* tb2,
                                            const CUtensorMap* tb1l, const CUtensorMap* tb2l) {
  const int tid = threadIdx.x - 2 * WG;  // 0 .. PRODUCER - 1
  const int Lres = C::DKV ? p.Lk : p.Lq, Lstr = C::DKV ? p.Lq : p.Lk;
  const int nt = (Lstr + C::BN - 1) / C::BN;
  const int total = C::SD && !C::DKV ? 2 * nt : nt;
  constexpr int T2 = C::PLANES * C::TILE_BYTES;  // tile 2 of a stage
  int stage = 0, phase = 0, rphase = 0;
  if constexpr (!C::CPASYNC) {
    if (tid != 0) return;  // one thread issues every copy
    // boxes of 64 bf16 columns x rows (128-byte swizzle) or of 8 (16 bytes)
    constexpr int BW = C::TMA ? 64 : 8;
    constexpr int BOXES = C::DP / BW, RBOX = C::RROWS * BW * 2, BBOX = C::BN * BW * 2;
    // CLUSTER: this block's columns of every row, from column DP rank on
    const int col0 = C::CS > 1 ? static_cast<int>(r.rank) * C::DP : 0;
    for (int w = first_item<C>(); w < bwd_items<C>(p); w += item_step<C>(), rphase ^= 1) {
      const Item it = bwd_item<C>(p, w);
      const long long sbase = ((long long)it.b * p.H + it.h) * p.sl;
      mbar_wait(r.rempty, rphase ^ 1);
      mbar_expect_tx(r.rfull, 2 * C::RES_BYTES);
      // (the 16-byte boxes' loops stay rolled: the producer keeps 40 registers)
#pragma unroll(C::TMA16 ? 1 : BOXES)
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(r.res + x * RBOX, ta1, r.rfull, col0 + x * BW, it.q0, it.h, it.b);
        tma_load_4d(r.res + C::RES_BYTES + x * RBOX, ta2, r.rfull, col0 + x * BW, it.q0, it.h,
                    it.b);
      }
      for (int i = 0; i < total; ++i) {
        const int c0 = (i % nt) * C::BN;
        mbar_wait(&r.empty[stage], phase ^ 1);
        const uint32_t t1 = r.stages + stage * C::STAGE_BYTES;
        mbar_expect_tx(&r.full[stage], C::STAGE_BYTES + C::STAT_BYTES);
#pragma unroll(C::TMA16 ? 1 : BOXES)
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(t1 + x * BBOX, tb1, &r.full[stage], col0 + x * BW, c0, it.h, it.b);
          tma_load_4d(t1 + T2 + x * BBOX, tb2, &r.full[stage], col0 + x * BW, c0, it.h, it.b);
          if constexpr (C::PLANES == 2) {
            tma_load_4d(t1 + C::TILE_BYTES + x * BBOX, tb1l, &r.full[stage], col0 + x * BW, c0,
                        it.h, it.b);
            tma_load_4d(t1 + T2 + C::TILE_BYTES + x * BBOX, tb2l, &r.full[stage], col0 + x * BW,
                        c0, it.h, it.b);
          }
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
      load_tile<C::DP, C::RROWS, C::PRODUCER>(r.res, a1, a1l, it.q0, Lres, p.dw, tid);
      load_tile<C::DP, C::RROWS, C::PRODUCER>(r.res + C::RES_BYTES, a2, a2l, it.q0, Lres, p.dw,
                                              tid);
      cp_async_commit();
      publish(r.rfull);
      for (int i = 0; i < total; ++i) {
        const int c0 = (i % nt) * C::BN;
        mbar_wait(&r.empty[stage], phase ^ 1);
        const uint32_t t1 = r.stages + stage * C::STAGE_BYTES;
        load_tile<C::DP, C::BN, C::PRODUCER>(t1, b1, b1l, c0, Lstr, p.dw, tid);
        load_tile<C::DP, C::BN, C::PRODUCER>(t1 + T2, b2, b2l, c0, Lstr, p.dw, tid);
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
      wgmma_ss_n128<C::F16>(s, a, b, kk > 0);
    else
      wgmma_ss_n64<C::F16>(s, a, b, kk > 0);
  }
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < C::DP / 16; ++kk) {
    const uint64_t a = kmajor_desc<C>(a2, QROWS, rg0, kk), b = kmajor_desc<C>(b2, C::BN, 0, kk);
    if constexpr (C::BN == 128)
      wgmma_ss_n128<C::F16>(t, a, b, kk > 0);
    else
      wgmma_ss_n64<C::F16>(t, a, b, kk > 0);
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
// 2kc + 1) are the A registers of k16 step kc, in bf16 or (F16) f16.
template <bool F16 = false>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float* x) {
  a[0] = pack2<F16>(x[0], x[1]);
  a[1] = pack2<F16>(x[2], x[3]);
  a[2] = pack2<F16>(x[4], x[5]);
  a[3] = pack2<F16>(x[6], x[7]);
}

// acc[.. DP / 2] += a (k16 steps of registers) . tile, the tile read MN-major
template <class C>
__device__ __forceinline__ void issue_rs(float* acc, uint32_t (*a)[4], uint32_t tile) {
#pragma unroll
  for (int kc = 0; kc < C::BN / 16; ++kc) pv_step<C, 0>(acc, a[kc], tile, kc);
}

// rows row and row + 8 of NB n8 blocks of acc (columns col0 ..), times f,
// to out (d columns valid), rounded to bf16 or (F16) f16
template <int NB, bool F16 = false>
__device__ __forceinline__ void store_cols(bf16* out, long long ld, int row, int nrows, int col0,
                                           int d, const float* acc, float f, int t4) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int col = col0 + j * 8 + t4 * 2;  // d % 8 == 0, so col < d implies col + 1 < d
    if (col < d) {
      if (row < nrows)
        *reinterpret_cast<uint32_t*>(out + (long long)row * ld + col) =
            pack2<F16>(acc[4 * j] * f, acc[4 * j + 1] * f);
      if (row + 8 < nrows)
        *reinterpret_cast<uint32_t*>(out + (long long)(row + 8) * ld + col) =
            pack2<F16>(acc[4 * j + 2] * f, acc[4 * j + 3] * f);
    }
  }
}

template <class C>
__device__ __forceinline__ void store_rows(bf16* out, long long ld, int row, int nrows, int d,
                                           const float* acc, float f, int t4) {
  store_cols<C::DP / 8, C::F16>(out, ld, row, nrows, 0, d, acc, f, t4);
}

template <class C>
__device__ __forceinline__ void wait_stage(const BRing& r, int stage, int phase) {
  mbar_wait(&r.full[stage], phase);
  if constexpr (C::CPASYNC) fence_proxy_async();
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
  if constexpr (C::CPASYNC) fence_proxy_async();
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
        pack_a<C::F16>(pa[kc], s + 8 * kc);
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
        pack_a<C::F16>(da[kc], dp + 8 * kc);
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
        pack_a<C::F16>(pa[kc], s + 8 * kc);
        pack_a<C::F16>(da[kc], dp + 8 * kc);
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
  if constexpr (C::CPASYNC) fence_proxy_async();

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
      pack_a<C::F16>(da[kc], dp + 8 * kc);
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

// ---------------------------------------------------------------------------
// SPLIT: #4 in bf16 at d = 256, one output accumulator a warpgroup
// ---------------------------------------------------------------------------

// D(64 x 32, f32) (+)= A(64 x 16, smem) * B(16 x 32, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// s = the item's 64 resident rows of tile a times the streamed tile b
// transposed (f32, unscaled), issued as one wgmma group
template <class C>
__device__ __forceinline__ void issue_one(float* s, uint32_t a_tile, uint32_t b_tile) {
  fence_regs<C::BN / 2>(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::DP / 16; ++kk) {
    const uint64_t a = kmajor_desc<C>(a_tile, C::RROWS, 0, kk);
    const uint64_t b = kmajor_desc<C>(b_tile, C::BN, 0, kk);
    if constexpr (C::BN == 128)
      wgmma_ss_n128(s, a, b, kk > 0);
    else if constexpr (C::BN == 64)
      wgmma_ss_n64(s, a, b, kk > 0);
    else
      wgmma_ss_n32(s, a, b, kk > 0);
  }
  wgmma_commit();
}

// One item of a dk/dv consumer (cw 0: dV, cw 1: dK) over every q tile
template <class C>
__device__ __forceinline__ void dkdv_item_split(const BwdArgs& p, const BRing& r, const Item& it,
                                                int cw, int t, int& stage, int& phase,
                                                int rphase) {
  const int warp = t / 32, g = (t % 32) >> 2, t4 = t & 3;
  const float c = p.scale * LOG2E;
  const int nt = (p.Lq + C::BN - 1) / C::BN;
  float acc[C::DP / 2], s[C::BN / 2];
  uint32_t a[C::BN / 16][4];
  float* x = at<float>(r, r.xchg) + t;  // p^T, this thread's element i at x[i WG]
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) acc[i] = 0.f;
  mbar_wait(r.rfull, rphase);
  if constexpr (C::CPASYNC) fence_proxy_async();
  for (int j = 0; j < nt; ++j) {
    wait_stage<C>(r, stage, phase);
    const uint32_t tq = r.stages + stage * C::STAGE_BYTES, tg = tq + C::TILE_BYTES;
    const float* st = r.stats + stage * 3 * C::BN;  // mb, iv, dd of the tile's q rows
    issue_one<C>(s, r.res + (cw ? C::RES_BYTES : 0), cw ? tg : tq);  // S^T = K Q^T, dP^T = V dO^T
    wgmma_wait<0>();
    fence_regs<C::BN / 2>(s);
    if (cw == 0) {
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) {  // p^T of q column 8 (i / 4) + 2 t4 + (i & 1)
        const int col = (i / 4) * 8 + 2 * t4 + (i & 1);
        s[i] = ex2(fmaf(s[i], c, -st[col])) * st[C::BN + col];
      }
      bar_sync(XEMPTY, 2 * WG);
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) x[i * WG] = s[i];
      bar_arrive(XFULL, 2 * WG);
    } else {
      bar_sync(XFULL, 2 * WG);
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) {
        const int col = (i / 4) * 8 + 2 * t4 + (i & 1);
        s[i] = ds_of<C>(x[i * WG], s[i], st[2 * C::BN + col], p.scale);
      }
      bar_arrive(XEMPTY, 2 * WG);
    }
#pragma unroll
    for (int kc = 0; kc < C::BN / 16; ++kc) pack_a(a[kc], s + 8 * kc);
    fence_regs<C::DP / 2>(acc);
    wgmma_fence();
    issue_rs<C>(acc, a, cw ? tq : tg);  // dV += round(p)^T dO, dK += round(ds)^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<C::DP / 2>(acc);
    fence_a<C::BN / 16>(a);
    mbar_arrive(&r.empty[stage]);
    next_stage<C>(stage, phase);
  }
  mbar_arrive(r.rempty);  // the last read of K and V is done
  const int row = it.q0 + warp * 16 + g;
  if (cw == 0)
    store_rows<C>(p.dv + it.b * p.dvb + it.h * p.dvh, p.dvl, row, p.Lk, p.d, acc, 1.f, t4);
  else
    store_rows<C>(p.dk + it.b * p.dkb + it.h * p.dkh, p.dkl, row, p.Lk, p.d, acc, 1.f, t4);
}

// One item of a dq consumer (cw 0: S, p and dQ's first half of columns;
// cw 1: dP, ds and the second half) over every K/V tile
template <class C>
__device__ __forceinline__ void dq_item_split(const BwdArgs& p, const BRing& r, const Item& it,
                                              int cw, int t, int& stage, int& phase, int rphase) {
  constexpr int HALF = C::DP / 2;
  const int warp = t / 32, g = (t % 32) >> 2, t4 = t & 3;
  const float c = p.scale * LOG2E;
  const int nt = (p.Lk + C::BN - 1) / C::BN;
  const int row = it.q0 + warp * 16 + g;
  // the forward's residuals of rows row and row + 8, formed as the wrapper
  // forms the dk/dv kernel's planes (m log2(e), the correctly rounded 1 / l)
  const long long rbase = ((long long)it.b * p.H + it.h) * p.Lq;
  const long long sbase = ((long long)it.b * p.H + it.h) * p.sl;
  const bool in0 = row < p.Lq, in1 = row + 8 < p.Lq;
  const float mb0 = in0 ? p.m[rbase + row] * LOG2E : 0.f;
  const float mb1 = in1 ? p.m[rbase + row + 8] * LOG2E : 0.f;
  const float iv0 = in0 ? __frcp_rn(p.l[rbase + row]) : 0.f;
  const float iv1 = in1 ? __frcp_rn(p.l[rbase + row + 8]) : 0.f;
  const float dd0 = in0 ? p.dd[sbase + row] : 0.f, dd1 = in1 ? p.dd[sbase + row + 8] : 0.f;
  float acc[HALF / 2], s[C::BN / 2];
  uint32_t a[C::BN / 16][4];
  float* x = at<float>(r, r.xchg) + t;  // p, element i at x[i WG]
  uint32_t* xa = at<uint32_t>(r, r.xchg + (C::BN / 2) * WG * 4) + t;  // ds's A registers
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) acc[i] = 0.f;
  mbar_wait(r.rfull, rphase);
  if constexpr (C::CPASYNC) fence_proxy_async();
  for (int j = 0; j < nt; ++j) {
    wait_stage<C>(r, stage, phase);
    const uint32_t tk = r.stages + stage * C::STAGE_BYTES, tv = tk + C::TILE_BYTES;
    issue_one<C>(s, r.res + (cw ? C::RES_BYTES : 0), cw ? tv : tk);  // S = Q K^T, dP = dO V^T
    wgmma_wait<0>();
    fence_regs<C::BN / 2>(s);
    if (cw == 0) {
      mask_keys<C>(s, j * C::BN, p.Lk, t4);
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i)
        s[i] = ex2(fmaf(s[i], c, -(i & 2 ? mb1 : mb0))) * (i & 2 ? iv1 : iv0);
      bar_sync(XEMPTY, 2 * WG);
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) x[i * WG] = s[i];
      bar_arrive(XFULL, 2 * WG);
      bar_sync(DFULL, 2 * WG);
#pragma unroll
      for (int kc = 0; kc < C::BN / 16; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[kc][e] = xa[(4 * kc + e) * WG];
      bar_arrive(DEMPTY, 2 * WG);
    } else {
      bar_sync(XFULL, 2 * WG);
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i)
        s[i] = ds_of<C>(x[i * WG], s[i], i & 2 ? dd1 : dd0, p.scale);
      bar_arrive(XEMPTY, 2 * WG);
#pragma unroll
      for (int kc = 0; kc < C::BN / 16; ++kc) pack_a(a[kc], s + 8 * kc);
      bar_sync(DEMPTY, 2 * WG);
#pragma unroll
      for (int kc = 0; kc < C::BN / 16; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) xa[(4 * kc + e) * WG] = a[kc][e];
      bar_arrive(DFULL, 2 * WG);
    }
    // this warpgroup's half of dQ += round(ds) K, K read MN-major
    fence_regs<HALF / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < C::BN / 16; ++kc)
      wgmma_rs_n128(acc, a[kc], vmajor_desc<C>(tk, kc, cw * HALF));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<HALF / 2>(acc);
    fence_a<C::BN / 16>(a);
    mbar_arrive(&r.empty[stage]);
    next_stage<C>(stage, phase);
  }
  mbar_arrive(r.rempty);  // the last read of Q and dO is done
  store_cols<HALF / 8>(p.dq + it.b * p.dqb + it.h * p.dqh, p.dql, row, p.Lq, cw * HALF, p.d, acc,
                       1.f, t4);
}

// ---------------------------------------------------------------------------
// TF32: #2 in f32 on 3xTF32 wgmma
// ---------------------------------------------------------------------------

// offset of the 16-byte segment c16 (f32 columns 4 c16 ..) of row `row` in
// a tile of `rows` rows as the producer lays it out
template <class C>
__device__ __forceinline__ uint32_t seg(int rows, int row, int c16) {
  if constexpr (C::TMA)
    return (c16 / 8) * rows * 128 + row * 128 + (((c16 % 8) ^ (row % 8)) << 4);
  else if constexpr (C::TMA16)
    return c16 * rows * 16 + row * 16;
  else
    return (row / 8) * C::DP * 16 + c16 * 128 + (row % 8) * 16;
}

// a tile of `rows` rows as the K-major operand of k8 step kk (TF32) from
// row group rg0: TMA16 tiles have their core matrices rows 16 bytes apart
// along K and 128 apart along the rows; the others as kmajor_desc
template <class C>
__device__ __forceinline__ uint64_t bdesc(uint32_t tile, int rows, int rg0, int kk) {
  if constexpr (C::TMA16)
    return make_desc(tile + 2 * kk * rows * 16 + rg0 * 128, rows * 16, 128, 0);
  else
    return kmajor_desc<C>(tile, rows, rg0, kk);
}

// the same in an exchange tile: 64 rows, 32-column boxes, 128-byte swizzle
__device__ __forceinline__ uint32_t xseg(int row, int c16) {
  return (c16 / 8) * 64 * 128 + row * 128 + (((c16 % 8) ^ (row % 8)) << 4);
}

// an exchange tile as the K-major B operand of k8 step kk (its rows are N)
__device__ __forceinline__ uint64_t xdesc(uint32_t tile, int kk) {
  return make_desc(tile + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024, 1);
}

// The split of a value formed in the kernel (the resident rows' A
// fragments, p and ds): hi = x rounded to TF32, to nearest with ties away
// (by integer add and mask: tf32_rna's bits for every x but a NaN), lo =
// x - hi exactly, which the tensor cores read truncated to TF32 (an error
// under 2^-21 of x, against 2^-22 for a rounded lo; a NaN x gives a NaN
// lo, so NaNs still reach the sums). cvt.rna.tf32.f32, twice an element,
// runs at 16 a clock an SM and held the consumers up.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// hi and lo of four values in place (hi holds them on entry)
__device__ __forceinline__ void split4(uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v = __uint_as_float(hi[e]), h = tf32_hi(v);
    lo[e] = __float_as_uint(__fsub_rn(v, h));
    hi[e] = __float_as_uint(h);
  }
}

// A of k8 step kk from the raw resident tile at `tile` (rows row0 + 16
// warp ..), split: ldmatrix's four 8 x 8 b16 matrices on 32-bit data are
// the TF32 fragment (rows +0 / +8, columns +0 / +4)
template <class C>
__device__ __forceinline__ void a_rows(uint32_t (&hi)[4], uint32_t (&lo)[4], uint32_t tile,
                                       int warp, int lane, int kk, int row0 = 0) {
  const int m = lane >> 3;
  ldmatrix_x4(hi, tile + seg<C>(C::RROWS, row0 + warp * 16 + (lane & 7) + 8 * (m & 1),
                                2 * kk + (m >> 1)));
  split4(hi, lo);
}

// A of k8 step kk of a transposed product from a streamed tile's hi plane
// at th (lo TILE_BYTES on): A's row m is the tile's column 64 mb + m, A's
// column k its row 8 kk + k; fragment element e is row g + 8 (e & 1),
// column t4 + 4 (e >> 1); columns past the head dim read as zero
template <class C>
__device__ __forceinline__ void a_cols(uint32_t (&hi)[4], uint32_t (&lo)[4], const BRing& r,
                                       uint32_t th, int mb, int warp, int g, int t4, int kk) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = 64 * mb + 16 * warp + g + 8 * (e & 1), row = 8 * kk + t4 + 4 * (e >> 1);
    if (col < C::DPF) {
      const uint32_t off = seg<C>(C::BN, row, col / 4) + (col % 4) * 4;
      hi[e] = *at<const uint32_t>(r, th + off);
      lo[e] = *at<const uint32_t>(r, th + C::TILE_BYTES + off);
    } else {
      hi[e] = lo[e] = 0u;
    }
  }
}

// acc = the sum over KS k8 steps of A B by three TF32 products a step
// (A lo B hi, A hi B lo, A hi B hi; the first from zero). A's hi and lo
// fragments come from load(kk, hi, lo) into one of two register buffers
// while the other's group runs; B's planes from desc(kk, 0 or 1).
template <int N, int KS, class Load, class Desc>
__device__ __forceinline__ void tf32x3(float* acc, Load load, Desc desc) {
  uint32_t hi[2][4], lo[2][4];
  load(0, hi[0], lo[0]);
  fence_regs<N / 2>(acc);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int b = kk & 1;
    const uint64_t bh = desc(kk, 0), bl = desc(kk, 1);
    wgmma_fence();
    wgmma_tf32_rs<N>(acc, lo[b], bh, kk > 0);
    wgmma_tf32_rs<N>(acc, hi[b], bl, 1);
    wgmma_tf32_rs<N>(acc, hi[b], bh, 1);
    wgmma_commit();
    if (kk + 1 < KS) {
      wgmma_wait<1>();  // the group before this one is done: its buffer is free
      fence_a<1>(&hi[b ^ 1]);
      fence_a<1>(&lo[b ^ 1]);
      load(kk + 1, hi[b ^ 1], lo[b ^ 1]);
    }
  }
  wgmma_wait<0>();
  fence_regs<N / 2>(acc);
  fence_a<2>(hi);
  fence_a<2>(lo);
}

// this thread's accumulator elements (rows 16 warp + g (+ 8), columns
// 8 j + 2 t4 (+ 1) of a 64 x BN tile) split to the exchange tiles at th
// (hi) and th + XTILE (lo)
template <class C>
__device__ __forceinline__ void put_split(const BRing& r, uint32_t th, const float* s, int warp,
                                          int g, int t4) {
#pragma unroll
  for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + g + 8 * h, col = 8 * j + 2 * t4;
      const uint32_t off = xseg(row, col / 4) + (col % 4) * 4;
      const float x0 = s[4 * j + 2 * h], x1 = s[4 * j + 2 * h + 1];
      const float h0 = tf32_hi(x0), h1 = tf32_hi(x1);
      *at<float2>(r, th + off) = make_float2(h0, h1);
      *at<float2>(r, th + C::XTILE + off) = make_float2(__fsub_rn(x0, h0), __fsub_rn(x1, h1));
    }
}

// out[n0 + n][m] = f acc (a d x 64 transposed product: m64 block mb holds
// rows m = 64 mb + 16 warp + g (+ 8), columns n = 8 j + 2 t4 (+ 1)), for
// rows n0 + n < nrows and columns m < d
template <int MB>
__device__ __forceinline__ void store_t(float* out, long long ld, int n0, int nrows, int d,
                                        const float (*acc)[32], float f, int warp, int g, int t4) {
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int m = 64 * mb + 16 * warp + g + 8 * ((i >> 1) & 1);
      const int n = n0 + 8 * (i / 4) + 2 * t4 + (i & 1);
      if (m < d && n < nrows) out[(long long)n * ld + m] = acc[mb][i] * f;
    }
}

// CLUSTER: s holds this warpgroup's tile (S^T or S for cw 0, dP^T or dP
// for cw 1) over this block's columns of d. Send it to every other block of
// the cluster -- remote stores into the buffer at shared address `buf`,
// element i of thread t at buf + 4 (i WG + t) plus PART_BYTES times the
// sender's index there (its rank, less one above the receiver's), then an
// arrival on the receiver's barrier `bar` -- wait for this block's `bar`
// phase of parity `parity` (the others' partials), and sum the CS partials
// in rank order, so every block holds the same bits.
template <class C>
__device__ __forceinline__ void cluster_sum(const BRing& r, float* s, int t, uint32_t buf,
                                            uint64_t* bar, int parity) {
  constexpr int H2 = C::BN / 2;
  const int rank = static_cast<int>(r.rank);
  auto elem = [&](int index) { return buf + index * C::PART_BYTES + t * 4; };
#pragma unroll
  for (int q = 0; q < C::CS; ++q) {
    if (q == rank) continue;
    const uint32_t dst = mapa(elem(rank - (rank > q)), q);
#pragma unroll
    for (int i = 0; i < H2; ++i) st_cluster(dst + i * WG * 4, s[i]);
    mbar_arrive_cluster(mapa(smem_u32(bar), q));
  }
  mbar_wait_cluster(bar, parity);
  float tot[H2];
#pragma unroll
  for (int q = 0; q < C::CS; ++q) {
    const uint32_t src = elem(q - (q > rank));
#pragma unroll
    for (int i = 0; i < H2; ++i) {
      const float v = q == rank ? s[i] : *at<const float>(r, src + i * WG * 4);
      tot[i] = q == 0 ? v : tot[i] + v;
    }
  }
#pragma unroll
  for (int i = 0; i < H2; ++i) s[i] = tot[i];
}

// CLUSTER, the exchange of tile n (this warpgroup's n-th) for role cw, the
// partial landing at `alias` (XALIAS) or in the receive slots (CS > 2: two
// in turn; a block sends tile n + 1 only after it has read its slot of tile
// n - 1, so the senders of tile n + 2 find it read). XALIAS sends tile n
// only after the other block freed `alias` from tile n - 1 (cluster_free).
template <class C>
__device__ __forceinline__ void cluster_tile(const BRing& r, float* s, int cw, int t, int n,
                                             uint32_t alias) {
  if constexpr (C::XALIAS) {
    if (n > 0) mbar_wait_cluster(&r.xfree[cw], (n - 1) & 1);
    cluster_sum<C>(r, s, t, alias, &r.xfull[cw], n & 1);
  } else {
    const int sel = (n & 1) * 2 + cw;
    cluster_sum<C>(r, s, t, r.recv + sel * (C::CS - 1) * C::PART_BYTES, &r.xfull[sel],
                   (n >> 1) & 1);
  }
}

// XALIAS: tell the other block that this block's buffer of role cw may take
// its next partial (one thread, after a barrier over the threads that read it)
__device__ __forceinline__ void cluster_free(const BRing& r, int cw) {
  mbar_arrive_cluster(mapa(smem_u32(&r.xfree[cw]), r.rank ^ 1));
}

// One item of a dk/dv consumer (cw 0: S^T, p, dV; cw 1: dP^T, ds, dK);
// xn counts this consumer's tiles (CLUSTER's exchanges), `last` marks the
// block's last item
template <class C>
__device__ __forceinline__ void dkdv_item_tf32(const BwdArgs& p, const BRing& r, const Item& it,
                                               int cw, int t, int& stage, int& phase,
                                               int rphase, int& xn, bool last) {
  constexpr int KS = C::DPF / 8, KQ = C::BN / 8, MB = C::MB;
  const int warp = t / 32, lane = t % 32, g = lane >> 2, t4 = lane & 3;
  const float c = p.scale * LOG2E;
  const int nt = (p.Lq + C::BN - 1) / C::BN;
  const uint32_t res = r.res + (cw ? C::RES_BYTES : 0);       // K or V
  const uint32_t xt = r.xchg + (cw ? 2 * C::XTILE : 0);       // P^T or dS^T, hi then lo
  float s[C::BN / 2], part[32], acc[MB][32];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mb][i] = 0.f;
  mbar_wait(r.rfull, rphase);
  if constexpr (C::CPASYNC) fence_proxy_async();
  for (int j = 0; j < nt; ++j) {
    wait_stage<C>(r, stage, phase);
    const uint32_t tq = r.stages + stage * C::STAGE_BYTES;  // Q hi, Q lo, dO hi, dO lo
    const uint32_t tg = tq + 2 * C::TILE_BYTES;
    const float* st = r.stats + stage * 3 * C::BN;  // mb, iv, dd of the tile's q rows
    const uint32_t tb = cw ? tg : tq;
    // S^T = K Q^T (cw 0), dP^T = V dO^T (cw 1)
    tf32x3<C::BN, KS>(
        s,
        [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
          a_rows<C>(h, l, res, warp, lane, kk);
        },
        [&](int kk, int pl) { return bdesc<C>(tb + pl * C::TILE_BYTES, C::BN, 0, kk); });
    // XALIAS: the other block's partial lands in this role's lo tile, which
    // put_split then overwrites
    const bool final_tile = last && j == nt - 1;
    if constexpr (C::CS > 1) cluster_tile<C>(r, s, cw, t, xn++, xt + C::XTILE);
    if (cw == 0) {
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) {  // p^T of q column 8 (i / 4) + 2 t4 + (i & 1)
        const int col = (i / 4) * 8 + 2 * t4 + (i & 1);
        s[i] = ex2(fmaf(s[i], c, -st[col])) * st[C::BN + col];
      }
      // warpgroup 1 has read the last tile's p (XALIAS: synced after dV^T)
      if constexpr (!C::XALIAS) bar_sync(XEMPTY, 2 * WG);
    } else {
      bar_sync(XFULL, 2 * WG);
#pragma unroll
      for (int jb = 0; jb < C::BN / 8; ++jb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // p = hi + lo (exactly) of the elements this thread holds
          const int row = warp * 16 + g + 8 * h, col = 8 * jb + 2 * t4;
          const uint32_t off = xseg(row, col / 4) + (col % 4) * 4;
          const float2 ph = *at<const float2>(r, r.xchg + off);
          const float2 pl = *at<const float2>(r, r.xchg + C::XTILE + off);
          const int i = 4 * jb + 2 * h;
          s[i] = ds_of<C>(ph.x + pl.x, s[i], st[2 * C::BN + col], p.scale);
          s[i + 1] = ds_of<C>(ph.y + pl.y, s[i + 1], st[2 * C::BN + col + 1], p.scale);
        }
      bar_arrive(XEMPTY, 2 * WG);
    }
    if constexpr (C::XALIAS) bar_sync(WGBAR + cw, WG);  // every thread has read its partial
    put_split<C>(r, xt, s, warp, g, t4);
    fence_proxy_async();
    if (cw == 0) bar_arrive(XFULL, 2 * WG);
    bar_sync(WGBAR + cw, WG);  // the whole tile is written before this warpgroup's wgmma reads it
    // dV^T = dO^T P (cw 0), dK^T = Q^T dS (cw 1), this tile's share from
    // zero, an m64 block of d at a time
    const uint32_t ta = cw ? tq : tg;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      tf32x3<64, KQ>(
          part,
          [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
            a_cols<C>(h, l, r, ta, mb, warp, g, t4, kk);
          },
          [&](int kk, int pl) { return xdesc(xt + pl * C::XTILE, kk); });
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mb][i] += part[i];
    }
    if constexpr (C::XALIAS) {
      // P^T (read by this wgmma and by warpgroup 1) and dS^T are free again:
      // the other block may send its next partial into them
      bar_sync(cw == 0 ? XEMPTY : WGBAR + 1, cw == 0 ? 2 * WG : WG);
      if (t == 0 && !final_tile) cluster_free(r, cw);
    }
    mbar_arrive(&r.empty[stage]);
    next_stage<C>(stage, phase);
  }
  mbar_arrive(r.rempty);  // the last read of K and V is done
  // CLUSTER: this block's DPF columns of dV and dK
  const int col0 = C::CS > 1 ? static_cast<int>(r.rank) * C::DPF : 0;
  const int d = C::CS > 1 ? C::DPF : p.d;
  if (cw == 0)
    store_t<MB>(reinterpret_cast<float*>(p.dv) + it.b * p.dvb + it.h * p.dvh + col0, p.dvl,
                it.q0, p.Lk, d, acc, 1.f, warp, g, t4);
  else
    store_t<MB>(reinterpret_cast<float*>(p.dk) + it.b * p.dkb + it.h * p.dkh + col0, p.dkl,
                it.q0, p.Lk, d, acc, C::SD ? p.scale : 1.f, warp, g, t4);
}

// One item of a dq consumer that owns its 64 q rows (OWN): the statistics
// pass (S and dP, the running max, l and the dsum sum), then the dq pass
// (S, dP, ds into this warpgroup's dS tiles, dQ^T), with no exchange
template <class C>
__device__ __forceinline__ void dq_item_tf32_own(const BwdArgs& p, const BRing& r, const Item& it,
                                                 int cw, int t, int& stage, int& phase,
                                                 int rphase) {
  constexpr int KS = C::DPF / 8, KK = C::BN / 8, MB = C::MB, H2 = C::BN / 2;
  const int warp = t / 32, lane = t % 32, g = lane >> 2, t4 = lane & 3;
  const float c = p.scale * LOG2E;
  const int nt = (p.Lk + C::BN - 1) / C::BN;
  const int row = it.q0 + 64 * cw + warp * 16 + g;
  const bool in0 = row < p.Lq, in1 = row + 8 < p.Lq;
  const long long sbase = ((long long)it.b * p.H + it.h) * p.sl;
  const uint32_t xd = r.xchg + cw * 2 * C::XTILE;  // this warpgroup's dS, hi then lo
  float s[H2], dp[H2];
  mbar_wait(r.rfull, rphase);
  if constexpr (C::CPASYNC) fence_proxy_async();
  // S = Q K^T and dP = dO V^T for this warpgroup's rows of the stage at tk
  auto logits = [&](uint32_t tk) {
    tf32x3<C::BN, KS>(
        s,
        [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
          a_rows<C>(h, l, r.res, warp, lane, kk, 64 * cw);
        },
        [&](int kk, int pl) { return bdesc<C>(tk + pl * C::TILE_BYTES, C::BN, 0, kk); });
    tf32x3<C::BN, KS>(
        dp,
        [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
          a_rows<C>(h, l, r.res + C::RES_BYTES, warp, lane, kk, 64 * cw);
        },
        [&](int kk, int pl) { return bdesc<C>(tk + (2 + pl) * C::TILE_BYTES, C::BN, 0, kk); });
  };

  // the statistics pass: running max M (unscaled), l and u = sum p dp,
  // both rescaled when M grows; dsum = u / l
  float M0 = -INFINITY, M1 = -INFINITY, l0 = 0.f, l1 = 0.f, u0 = 0.f, u1 = 0.f;
  for (int j = 0; j < nt; ++j) {
    wait_stage<C>(r, stage, phase);
    logits(r.stages + stage * C::STAGE_BYTES);
    mbar_arrive(&r.empty[stage]);
    next_stage<C>(stage, phase);
    mask_keys<C>(s, j * C::BN, p.Lk, t4);
    // the first tile always holds a valid key, so mn is finite from here on
    const float2 mn = tile_max(s, H2, M0, M1);
    const float b0 = (mn.x * p.scale) * LOG2E, b1 = (mn.y * p.scale) * LOG2E;
    const float a0 = ex2((M0 * p.scale) * LOG2E - b0), a1 = ex2((M1 * p.scale) * LOG2E - b1);
    float sum0 = 0.f, sum1 = 0.f, su0 = 0.f, su1 = 0.f;
#pragma unroll
    for (int i = 0; i < H2; i += 4) {
      const float e0 = ex2(fmaf(s[i], c, -b0)), e1 = ex2(fmaf(s[i + 1], c, -b0));
      const float e2 = ex2(fmaf(s[i + 2], c, -b1)), e3 = ex2(fmaf(s[i + 3], c, -b1));
      sum0 += e0 + e1;
      sum1 += e2 + e3;
      su0 = fmaf(e0, dp[i], fmaf(e1, dp[i + 1], su0));
      su1 = fmaf(e2, dp[i + 2], fmaf(e3, dp[i + 3], su1));
    }
    l0 = l0 * a0 + quad_sum(sum0);
    l1 = l1 * a1 + quad_sum(sum1);
    u0 = u0 * a0 + quad_sum(su0);
    u1 = u1 * a1 + quad_sum(su1);
    M0 = mn.x;
    M1 = mn.y;
  }
  const float mb0 = (M0 * p.scale) * LOG2E, mb1 = (M1 * p.scale) * LOG2E;  // m = scale max s
  const float iv0 = __frcp_rn(l0), iv1 = __frcp_rn(l1);
  const float dd0 = u0 * iv0, dd1 = u1 * iv1;
  if (t4 == 0) {  // for the dk/dv kernel; rows past Lq give it p = 0
    p.mb[sbase + row] = in0 ? mb0 : INFINITY;
    p.iv[sbase + row] = in0 ? iv0 : 0.f;
    p.dd[sbase + row] = in0 ? dd0 : 0.f;
    p.mb[sbase + row + 8] = in1 ? mb1 : INFINITY;
    p.iv[sbase + row + 8] = in1 ? iv1 : 0.f;
    p.dd[sbase + row + 8] = in1 ? dd1 : 0.f;
  }

  // the dq pass: dQ^T += K^T dS^T, each tile's share from zero
  float part[32], acc[MB][32];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mb][i] = 0.f;
  for (int j = 0; j < nt; ++j) {
    wait_stage<C>(r, stage, phase);
    const uint32_t tk = r.stages + stage * C::STAGE_BYTES;  // K hi, K lo, V hi, V lo
    logits(tk);
    mask_keys<C>(s, j * C::BN, p.Lk, t4);
#pragma unroll
    for (int i = 0; i < H2; ++i) {
      const float pe = ex2(fmaf(s[i], c, -(i & 2 ? mb1 : mb0))) * (i & 2 ? iv1 : iv0);
      s[i] = ds_of<C>(pe, dp[i], i & 2 ? dd1 : dd0, p.scale);
    }
    put_split<C>(r, xd, s, warp, g, t4);
    fence_proxy_async();
    bar_sync(WGBAR + cw, WG);  // the whole tile is written before the wgmma reads it
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {  // an m64 block of d at a time
      tf32x3<64, KK>(
          part,
          [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
            a_cols<C>(h, l, r, tk, mb, warp, g, t4, kk);
          },
          [&](int kk, int pl) { return xdesc(xd + pl * C::XTILE, kk); });
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mb][i] += part[i];
    }
    mbar_arrive(&r.empty[stage]);
    next_stage<C>(stage, phase);
  }
  mbar_arrive(r.rempty);  // the last read of Q and dO is done
  store_t<MB>(reinterpret_cast<float*>(p.dq) + it.b * p.dqb + it.h * p.dqh, p.dql,
              it.q0 + 64 * cw, p.Lq, p.d, acc, p.scale, warp, g, t4);
}

// One item of a dq consumer: for #2 the statistics pass (cw 0: S, the
// running max and l; cw 1: dP and the dsum sum), for #4 the forward's
// residuals; then the dq pass (cw 0: S and p; cw 1: dP, ds and dQ^T); xn
// counts this consumer's dq-pass tiles (CLUSTER's exchanges), `last` marks
// the block's last item
template <class C>
__device__ __forceinline__ void dq_item_tf32(const BwdArgs& p, const BRing& r, const Item& it,
                                             int cw, int t, int& stage, int& phase, int rphase,
                                             int& xn, bool last) {
  constexpr int KS = C::DPF / 8, KK = C::BN / 8, MB = C::MB, H2 = C::BN / 2;
  const int warp = t / 32, lane = t % 32, g = lane >> 2, t4 = lane & 3;
  const float c = p.scale * LOG2E;
  const int nt = (p.Lk + C::BN - 1) / C::BN;
  const int row = it.q0 + warp * 16 + g;
  const bool in0 = row < p.Lq, in1 = row + 8 < p.Lq;
  const long long sbase = ((long long)it.b * p.H + it.h) * p.sl;
  const uint32_t res = r.res + (cw ? C::RES_BYTES : 0);  // Q or dO
  float* x = at<float>(r, r.xchg + 2 * C::XTILE) + t;     // element i at x[i WG]
  float s[H2];
  mbar_wait(r.rfull, rphase);
  if constexpr (C::CPASYNC) fence_proxy_async();
  // S = Q K^T (cw 0) or dP = dO V^T (cw 1) of the stage at tk
  auto logits = [&](uint32_t tk) {
    const uint32_t tb = tk + (cw ? 2 * C::TILE_BYTES : 0);
    tf32x3<C::BN, KS>(
        s,
        [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
          a_rows<C>(h, l, res, warp, lane, kk);
        },
        [&](int kk, int pl) { return bdesc<C>(tb + pl * C::TILE_BYTES, C::BN, 0, kk); });
  };

  // the rows' statistics: warpgroup 0 m log2 e and 1 / l, warpgroup 1 dd
  float mb0 = 0.f, mb1 = 0.f, iv0 = 0.f, iv1 = 0.f, dd0 = 0.f, dd1 = 0.f;
  if constexpr (!C::SD) {
    // #4: the forward's residuals, formed as the wrapper forms the dk/dv
    // kernel's planes (m log2(e), the correctly rounded 1 / l), and di
    const long long rbase = ((long long)it.b * p.H + it.h) * p.Lq;
    if (cw == 0) {
      mb0 = in0 ? p.m[rbase + row] * LOG2E : 0.f;
      mb1 = in1 ? p.m[rbase + row + 8] * LOG2E : 0.f;
      iv0 = in0 ? __frcp_rn(p.l[rbase + row]) : 0.f;
      iv1 = in1 ? __frcp_rn(p.l[rbase + row + 8]) : 0.f;
    } else {
      dd0 = in0 ? p.dd[sbase + row] : 0.f;
      dd1 = in1 ? p.dd[sbase + row + 8] : 0.f;
    }
  } else {
    // #2: the statistics pass: running max M (unscaled), l and u = sum p dp,
    // both rescaled when M grows; dsum = u / l
    float M0 = -INFINITY, M1 = -INFINITY, l0 = 0.f, l1 = 0.f, u0 = 0.f, u1 = 0.f;
    for (int j = 0; j < nt; ++j) {
      wait_stage<C>(r, stage, phase);
      logits(r.stages + stage * C::STAGE_BYTES);
      mbar_arrive(&r.empty[stage]);
      next_stage<C>(stage, phase);
      if (cw == 0) {
        mask_keys<C>(s, j * C::BN, p.Lk, t4);
        // the first tile always holds a valid key, so mn is finite from here on
        const float2 mn = tile_max(s, H2, M0, M1);
        const float b0 = (mn.x * p.scale) * LOG2E, b1 = (mn.y * p.scale) * LOG2E;
        const float a0 = ex2((M0 * p.scale) * LOG2E - b0), a1 = ex2((M1 * p.scale) * LOG2E - b1);
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
        bar_sync(XEMPTY, 2 * WG);
#pragma unroll
        for (int i = 0; i < H2; ++i) x[i * WG] = s[i];
        x[H2 * WG] = a0;
        x[(H2 + 1) * WG] = a1;
        bar_arrive(XFULL, 2 * WG);
        l0 = l0 * a0 + quad_sum(sum0);
        l1 = l1 * a1 + quad_sum(sum1);
        M0 = mn.x;
        M1 = mn.y;
      } else {
        bar_sync(XFULL, 2 * WG);
        float su0 = 0.f, su1 = 0.f;
#pragma unroll
        for (int i = 0; i < H2; i += 4) {
          su0 = fmaf(x[i * WG], s[i], fmaf(x[(i + 1) * WG], s[i + 1], su0));
          su1 = fmaf(x[(i + 2) * WG], s[i + 2], fmaf(x[(i + 3) * WG], s[i + 3], su1));
        }
        const float a0 = x[H2 * WG], a1 = x[(H2 + 1) * WG];
        bar_arrive(XEMPTY, 2 * WG);
        u0 = u0 * a0 + quad_sum(su0);
        u1 = u1 * a1 + quad_sum(su1);
      }
    }
    // the rows' statistics, for the dq pass and the dk/dv kernel (rows past
    // Lq give it p = 0)
    if (cw == 0) {
      mb0 = (M0 * p.scale) * LOG2E;  // m = scale max s, as #4's residual
      mb1 = (M1 * p.scale) * LOG2E;
      iv0 = __frcp_rn(l0);
      iv1 = __frcp_rn(l1);
      bar_sync(XEMPTY, 2 * WG);
      x[0] = iv0;
      x[WG] = iv1;
      bar_arrive(XFULL, 2 * WG);
      if (t4 == 0) {
        p.mb[sbase + row] = in0 ? mb0 : INFINITY;
        p.iv[sbase + row] = in0 ? iv0 : 0.f;
        p.mb[sbase + row + 8] = in1 ? mb1 : INFINITY;
        p.iv[sbase + row + 8] = in1 ? iv1 : 0.f;
      }
    } else {
      bar_sync(XFULL, 2 * WG);
      iv0 = x[0];
      iv1 = x[WG];
      bar_arrive(XEMPTY, 2 * WG);
      dd0 = u0 * iv0;
      dd1 = u1 * iv1;
      if (t4 == 0) {
        p.dd[sbase + row] = in0 ? dd0 : 0.f;
        p.dd[sbase + row + 8] = in1 ? dd1 : 0.f;
      }
    }
  }

  // the dq pass: dQ^T += K^T dS^T, each tile's share from zero
  float part[32], acc[MB][32];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mb][i] = 0.f;
  for (int j = 0; j < nt; ++j) {
    wait_stage<C>(r, stage, phase);
    const uint32_t tk = r.stages + stage * C::STAGE_BYTES;  // K hi, K lo, V hi, V lo
    logits(tk);
    // XALIAS: the other block's S partial lands in the f32 exchange (each
    // thread's elements where it then writes p), its dP partial in dS's lo
    // tile, which put_split then overwrites
    const bool final_tile = last && j == nt - 1;
    if constexpr (C::CS > 1)
      cluster_tile<C>(r, s, cw, t, xn++, r.xchg + (cw ? C::XTILE : 2 * C::XTILE));
    if (cw == 0) {
      mask_keys<C>(s, j * C::BN, p.Lk, t4);
#pragma unroll
      for (int i = 0; i < H2; ++i)
        s[i] = ex2(fmaf(s[i], c, -(i & 2 ? mb1 : mb0))) * (i & 2 ? iv1 : iv0);
      bar_sync(XEMPTY, 2 * WG);
#pragma unroll
      for (int i = 0; i < H2; ++i) x[i * WG] = s[i];
      bar_arrive(XFULL, 2 * WG);
    } else {
      bar_sync(XFULL, 2 * WG);
#pragma unroll
      for (int i = 0; i < H2; ++i) s[i] = ds_of<C>(x[i * WG], s[i], i & 2 ? dd1 : dd0, p.scale);
      bar_arrive(XEMPTY, 2 * WG);
      if constexpr (C::XALIAS) {
        bar_sync(WGBAR + 1, WG);  // p and the dP partial are read: the exchange is free
        if (t == 0 && !final_tile) cluster_free(r, 0);
      }
      put_split<C>(r, r.xchg, s, warp, g, t4);
      fence_proxy_async();
      bar_sync(WGBAR + 1, WG);  // the whole tile is written before the wgmma reads it
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {  // an m64 block of d at a time
        tf32x3<64, KK>(
            part,
            [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
              a_cols<C>(h, l, r, tk, mb, warp, g, t4, kk);
            },
            [&](int kk, int pl) { return xdesc(r.xchg + pl * C::XTILE, kk); });
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[mb][i] += part[i];
      }
      if constexpr (C::XALIAS) {
        bar_sync(WGBAR + 1, WG);  // dQ^T's wgmma has read dS: its lo tile is free
        if (t == 0 && !final_tile) cluster_free(r, 1);
      }
    }
    mbar_arrive(&r.empty[stage]);
    next_stage<C>(stage, phase);
  }
  mbar_arrive(r.rempty);  // the last read of Q and dO is done
  if (cw == 1) {
    // CLUSTER: this block's DPF columns of dQ
    const int col0 = C::CS > 1 ? static_cast<int>(r.rank) * C::DPF : 0;
    store_t<MB>(reinterpret_cast<float*>(p.dq) + it.b * p.dqb + it.h * p.dqh + col0, p.dql, it.q0,
                p.Lq, C::CS > 1 ? C::DPF : p.d, acc, C::SD ? p.scale : 1.f, warp, g, t4);
  }
}

template <class C>
__device__ __forceinline__ void bwd_consume(const BwdArgs& p, const BRing& r, int cw) {
  const int t = threadIdx.x - WG * cw;
  const int warp = t / 32, g = (t % 32) >> 2, t4 = t & 3;
  int stage = 0, phase = 0, rphase = 0, xn = 0;
  // XALIAS's dk/dv kernel syncs XEMPTY after each tile's products instead
  constexpr bool LEAD = C::KIND != PAIR && !(C::XALIAS && C::DKV);
  if constexpr (C::KIND != PAIR) {
    // each exchange starts empty: its reader's arrivals lead its writer's
    // waits by one, and the writer takes the last one at the end
    if (LEAD && cw == 1) bar_arrive(XEMPTY, 2 * WG);
    if (C::KIND == SPLIT && !C::DKV && cw == 0) bar_arrive(DEMPTY, 2 * WG);
  }
  for (int w = first_item<C>(); w < bwd_items<C>(p); w += item_step<C>(), rphase ^= 1) {
    const Item it = bwd_item<C>(p, w);
    const bool last = w + item_step<C>() >= bwd_items<C>(p);
    if constexpr (C::KIND == PAIR) {
      if constexpr (C::DKV)
        dkdv_item<C>(p, r, it, cw * 8, warp, g, t4, stage, phase, rphase);
      else
        dq_item<C>(p, r, it, cw * 8, warp, g, t4, stage, phase, rphase);
    } else if constexpr (C::KIND == SPLIT) {
      if constexpr (C::DKV)
        dkdv_item_split<C>(p, r, it, cw, t, stage, phase, rphase);
      else
        dq_item_split<C>(p, r, it, cw, t, stage, phase, rphase);
    } else {
      if constexpr (C::DKV)
        dkdv_item_tf32<C>(p, r, it, cw, t, stage, phase, rphase, xn, last);
      else if constexpr (C::OWN)
        dq_item_tf32_own<C>(p, r, it, cw, t, stage, phase, rphase);
      else
        dq_item_tf32<C>(p, r, it, cw, t, stage, phase, rphase, xn, last);
    }
  }
  if constexpr (C::KIND != PAIR) {
    if (LEAD && cw == 0) bar_sync(XEMPTY, 2 * WG);
    if (C::KIND == SPLIT && !C::DKV && cw == 1) bar_sync(DEMPTY, 2 * WG);
  }
}

// a persistent 1-d grid of at most one block an SM, each walking items;
// C::THREADS threads, C::SMEM bytes of dynamic shared memory; the tensor
// maps (resident tiles 1 and 2, streamed tiles 1 and 2, and TF32's lo
// planes of the streamed tiles) are read only on the TMA path
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    attn_bwd_sm90(const BwdArgs p, const __grid_constant__ CUtensorMap ta1,
                  const __grid_constant__ CUtensorMap ta2, const __grid_constant__ CUtensorMap tb1,
                  const __grid_constant__ CUtensorMap tb2, const __grid_constant__ CUtensorMap tb1l,
                  const __grid_constant__ CUtensorMap tb2l) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);  // 1024-byte aligned
  uint64_t* bars = reinterpret_cast<uint64_t*>(base);
  BRing r;
  r.full = bars;
  r.empty = bars + C::STAGES;
  r.rfull = bars + 2 * C::STAGES;
  r.rempty = bars + 2 * C::STAGES + 1;
  r.sbase = smem_u32(base);
  r.gbase = base;
  r.res = r.sbase + 1024;
  r.stages = r.res + 2 * C::RES_BYTES;
  r.xchg = r.stages + C::STAGES * C::STAGE_BYTES;
  r.recv = r.xchg + C::XBYTES;
  r.xfull = bars + 2 * C::STAGES + 2;
  r.xfree = bars + 2 * C::STAGES + 6;
  r.rank = C::CS > 1 ? cluster_rank() : 0;
  r.stats = at<float>(r, r.recv + C::RECV_BYTES);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&r.full[s], C::CPASYNC ? C::PRODUCER : 1);
      mbar_init(&r.empty[s], 2 * WG);
    }
    mbar_init(r.rfull, C::CPASYNC ? C::PRODUCER : 1);
    mbar_init(r.rempty, 2 * WG);
    // CLUSTER: a slot's partials arrive from the warpgroup of its role in
    // each of the other blocks; XALIAS's frees from one thread of the other
    for (int x = 0; x < (C::CS > 1 ? 4 : 0); ++x) mbar_init(&r.xfull[x], (C::CS - 1) * WG);
    for (int x = 0; x < (C::XALIAS ? 2 : 0); ++x) mbar_init(&r.xfree[x], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // CLUSTER: no block sends before every block's barriers are set up
  if constexpr (C::CS > 1)
    cluster_sync();
  else
    __syncthreads();
  if (threadIdx.x >= 2 * WG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    bwd_produce<C>(p, r, &ta1, &ta2, &tb1, &tb2, &tb1l, &tb2l);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    bwd_consume<C>(p, r, threadIdx.x / WG);
  }
}

// Launch attn_bwd_sm90<C> on `stream`; returns the CUDA error (0 on success).
template <class C>
int launch_bwd_sm90(const BwdArgs& p, cudaStream_t stream) {
  CUtensorMap m[6];
  memset(m, 0, sizeof(m));
  if constexpr (!C::CPASYNC) {
    const int Lstr = C::DKV ? p.Lq : p.Lk;
    constexpr int BW = C::TMA ? 64 : 8;
    // resident tiles 1 and 2 (K and V, or Q and dO), then the streamed ones
    auto map = [&](CUtensorMap* mp, const bf16* t, int L, long long sl, long long sh,
                   long long sb, int rows) {
      return make_map(mp, t, p.dw, L, p.H, p.B, sl, sh, sb, rows, BW, map_type<C::F16>());
    };
    bool ok = C::DKV ? map(&m[0], p.k, p.Lk, p.kl, p.kh, p.kb, C::RROWS) &&
                           map(&m[1], p.v, p.Lk, p.vl, p.vh, p.vb, C::RROWS)
                     : map(&m[0], p.q, p.Lq, p.ql, p.qh, p.qb, C::RROWS) &&
                           map(&m[1], p.g, p.Lq, p.gl, p.gh, p.gb, C::RROWS);
    if constexpr (C::PLANES == 1) {
      ok = ok && (C::DKV ? map(&m[2], p.q, p.Lq, p.ql, p.qh, p.qb, C::BN) &&
                               map(&m[3], p.g, p.Lq, p.gl, p.gh, p.gb, C::BN)
                         : map(&m[2], p.k, p.Lk, p.kl, p.kh, p.kb, C::BN) &&
                               map(&m[3], p.v, p.Lk, p.vl, p.vh, p.vb, C::BN));
    } else {
      // the split planes: contiguous (B, H, Lstr, dw), each lo plane after its hi plane
      const long long row = p.dw, head = row * Lstr, batch = head * p.H, lo = batch * p.B;
      const bf16* h1 = C::DKV ? p.hq : p.hk;
      const bf16* h2 = C::DKV ? p.hg : p.hv;
      ok = ok && map(&m[2], h1, Lstr, row, head, batch, C::BN) &&
           map(&m[3], h2, Lstr, row, head, batch, C::BN) &&
           map(&m[4], h1 + lo, Lstr, row, head, batch, C::BN) &&
           map(&m[5], h2 + lo, Lstr, row, head, batch, C::BN);
    }
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
  const int n = ((C::DKV ? p.Lk : p.Lq) + C::RROWS - 1) / C::RROWS * p.H * p.B;
  if constexpr (C::CS == 1) {
    const int blocks = n < sms ? n : sms;
    attn_bwd_sm90<C><<<blocks, C::THREADS, C::SMEM, stream>>>(p, m[0], m[1], m[2], m[3], m[4],
                                                               m[5]);
    return static_cast<int>(cudaGetLastError());
  } else {
    // CLUSTER: clusters of CS blocks, at most as many as fit the card at once
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C::CS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.blockDim = dim3(C::THREADS);
    cfg.dynamicSmemBytes = C::SMEM;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    static int fit = 0;
    if (fit == 0) {
      cfg.gridDim = dim3((sms / C::CS) * C::CS);
      err = cudaOccupancyMaxActiveClusters(&fit, attn_bwd_sm90<C>, &cfg);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    cfg.gridDim = dim3((n < fit ? n : fit) * C::CS);
    err = cudaLaunchKernelEx(&cfg, attn_bwd_sm90<C>, p, m[0], m[1], m[2], m[3], m[4], m[5]);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
}

// ---------------------------------------------------------------------------
// the TF32 split pass of the streamed tensors (#2's and #4's f32 backwards,
// #1's f32 forward for K)
// ---------------------------------------------------------------------------

// hi = tf32(x), lo = tf32(x - hi) of a (B, H, L, d) f32 tensor with element
// strides (b, h, l) into two contiguous (B, H, L, d) planes, hi then lo, n
// elements each; four floats a thread (d % 8 == 0, 16-byte rows)
__global__ void tf32_split_bhld(const float* x, long long sb, long long sh, long long sl, int H,
                                int L, int d, float* hi, long long n) {
  for (long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4; i < n;
       i += 4ll * gridDim.x * blockDim.x) {
    const int c = static_cast<int>(i % d);
    long long r = i / d;
    const int l = static_cast<int>(r % L);
    r /= L;
    const int h = static_cast<int>(r % H);
    const float4 v = *reinterpret_cast<const float4*>(x + (r / H) * sb + h * sh + l * sl + c);
    const float e[4] = {v.x, v.y, v.z, v.w};
    float out_hi[4], out_lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out_hi[j] = tf32_rna(e[j]);
      out_lo[j] = tf32_rna(__fsub_rn(e[j], out_hi[j]));
    }
    *reinterpret_cast<float4*>(hi + i) = make_float4(out_hi[0], out_hi[1], out_hi[2], out_hi[3]);
    *reinterpret_cast<float4*>(hi + n + i) =
        make_float4(out_lo[0], out_lo[1], out_lo[2], out_lo[3]);
  }
}

inline int split(const float* x, const Strides& s, int B, int H, int L, int d, float* hi,
                 cudaStream_t stream) {
  const long long n = (long long)B * H * L * d;
  const long long blocks = (n / 4 + 255) / 256;
  tf32_split_bhld<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      x, s.b, s.h, s.l, H, L, d, hi, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
