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
// Four forwards, each at one block an SM walking (q tile, head, batch)
// items of a persistent grid, with a producer filling a TMA ring:
// - bf16, d = 128 and 256: the Hopper mainloop of attention_sm90.cuh in
//   one-pass mode: 128 q rows a block on two consumer warpgroups (64 each),
//   `wgmma` for Q.K^T and P.V with p going from the logits' accumulator
//   straight into P.V's A registers; 128-key K/V tiles at d = 128, 64-key
//   tiles at d = 256 (a 128-row q tile is 64 KB there and a 64-key stage
//   another 64 KB), whose consumers hold a 64 x 256 f32 O (128 registers a
//   thread; `setmaxnreg` 232 / 40). The running max is kept on the unscaled
//   logits and p taken as 2^(c s - c m) with c = sm_scale log2(e), the same
//   exp as above.
// - f32, d = 128 and 256 (FLUX under `--precision float32` from 1280 px):
//   the 3xTF32 mainloop of attention_fwd_tf32.cuh (every product three TF32
//   `wgmma`s a k8 step) in its one-pass plans, after split passes write K's
//   TF32 hi and lo planes and V's transposed into the wrapper's scratch.
//   d = 128 (FWD_ONE_PASS): 128 q rows, 32-key stages of four planes; d =
//   256 (FWD_SPLIT_D): 64 q rows, the two consumer warpgroups each
//   contracting half of d for S (the partial S tiles summed through shared
//   memory, so both hold the same bits) and owning half of O's columns.
//   p, unnormalised, needs no rounding (v's dtype is f32).
// - f32, d = 512 (the VAE's single-head mid attention): flash_fwd_f32_d512,
//   one block owns 64 q rows across all of d, so the logits of a K tile are
//   summed once (see the kernel), on plain FMAs.
// Shapes: Lq % 64 == 0, Lk % 128 == 0, bf16 d = 128 or 256, f32 d = 128,
// 256 or 512 (the routing gate asks L % 128 == 0 and d % 128 == 0; the
// wrapper refuses the other head dims); strides for batch, head and row with
// a contiguous last dim, so q/k/v can be head views of (B, L, H*d)
// projections and o a (B, H, L, d) view of a (B, L, H, d) buffer.
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
//   dP, dQ^T) and no statistics pass. The forward's 3xTF32 plan writes
//   those residuals.
// - f32 at d = 256 and 512 (no path runs them): the TF32 plan on a
//   cluster of d / 128 blocks that split d (CLUSTER in the mainloop's
//   note): each block holds 128 columns of the 64 resident rows and
//   streams the same columns of 32-row (d = 512: 16-row) tiles, forms partial S^T and dP^T
//   (S and dP) over them, the partials cross between the blocks through
//   distributed shared memory and are summed in rank order, and each block
//   owns its 128 columns of dV, dK (dQ). A single block could not hold
//   the 64 resident rows across d = 256 (128 KB) beside two stages of
//   streamed hi and lo planes.

#include "sd_attention_common.cuh"
#include "attention_sm90.cuh"
#include "attention_bwd_sm90.cuh"
#include "attention_fwd_tf32.cuh"

namespace {

constexpr int FK = 128;  // keys per tile: the TPU kernel's block_k (d = 512, bf16 d = 128)
constexpr int BR = 64;   // the backward's rows: Lq and Lk are multiples of it

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

// ---------------------------------------------------------------------------
// f32 at d = 512: the VAE's single-head mid attention
// ---------------------------------------------------------------------------

// One block owns 64 q rows across all 512 columns of d, so the logits of a
// K tile are summed once over d (a block per 128-wide output chunk would sum
// them four times). 512 threads.
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
        // online softmax over this 128-key block: p = exp(s - m'),
        // unnormalised, and the rescale exp(m - m')
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

}  // namespace

// Returns the CUDA error of the launch (0 on success). Pointers 16-byte
// aligned, Lq % 64 == 0, Lk % 128 == 0, bf16 d = 128 or 256, f32 d = 128,
// 256 or 512, strides (in elements) multiples of 8 with a contiguous last
// dim, and at f32 d = 128 and 256 `scratch` 16-byte aligned f32 room for
// K's hi and lo planes and V^T's (4 B H Lk d floats; null otherwise); the
// Python wrapper checks all of this. `ml`, if not null, receives the (2, B,
// H, Lq) f32 residuals m and l.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* ml,
                                   float* scratch, int B, int H, int Lq, int Lk, int d, int is_f32,
                                   long long q_sb, long long q_sh, long long q_sl, long long k_sb,
                                   long long k_sh, long long k_sl, long long v_sb, long long v_sh,
                                   long long v_sl, long long o_sb, long long o_sh, long long o_sl,
                                   float scale, void* stream) {
  const bool tf32 = is_f32 && (d == 128 || d == 256);
  // the d = 512 kernel's blocks take XQ q rows and FK-key tiles, unmasked
  if (B < 1 || H < 1 || Lq < XQ || Lk < FK || Lq % XQ || Lk % FK || B > 65535 ||
      H > 65535 || (is_f32 ? !tf32 && d != XD : d != 128 && d != 256) ||
      (tf32 && (scratch == nullptr || (long long)B * H > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32 && d == XD) {
    const FParams p{q, k, v, o, static_cast<float*>(ml), Lk, d,
                    {q_sb, q_sh, q_sl}, {k_sb, k_sh, k_sl}, {v_sb, v_sh, v_sl}, {o_sb, o_sh, o_sl},
                    scale};
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_d512, cudaFuncAttributeMaxDynamicSharedMemorySize, X_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_f32_d512<<<dim3(Lq / XQ, H, B), XT, X_SMEM, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  // f32 rows are handed over as bf16 rows of twice the width (q's strides
  // doubled; o is stored as f32)
  const long long x = tf32 ? 2 : 1;
  const sm90::Params sp{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                        static_cast<const bf16*>(v), static_cast<bf16*>(o),
                        static_cast<float*>(ml), Lq, Lk, d, B, H,
                        x * q_sb, x * q_sh, x * q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl,
                        o_sb, o_sh, o_sl, scale};
  using sm90::FCfg;
  if (tf32) {
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const Strides ks{k_sb, k_sh, k_sl}, vs{v_sb, v_sh, v_sl};
    return d == 128
               ? sm90::launch_fwd_tf32<FCfg<128, 32, true, sm90::FWD_ONE_PASS>>(sp, kf, ks, vf, vs,
                                                                                 scratch, st)
               : sm90::launch_fwd_tf32<FCfg<256, 32, true, sm90::FWD_SPLIT_D>>(sp, kf, ks, vf, vs,
                                                                               scratch, st);
  }
  return d == 128 ? sm90::launch<sm90::Cfg<128, FK, true, false, 1>>(sp, st)
                  : sm90::launch<sm90::Cfg<256, 64, true, false, 1>>(sp, st);
}

// One backward kernel: part 0 the dk/dv kernel (writes dk, dv), part 1 the
// dq kernel (writes dq). m, l and di are (B, H, Lq) f32, contiguous; the
// kernels read two more planes after di, m log2(e) and 1 / l (the wrapper
// forms them), from a 16-byte aligned di, and f32 takes 4 B H max(Lq, Lk)
// d floats more after them for the split planes. Returns the launch's CUDA
// error (0 on success). Shapes and strides as for the forward, with Lq and
// Lk multiples of 64, bf16 d = 128 or 256 and f32 d = 128, 256 or 512; the
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
  if (B < 1 || H < 1 || Lq < BR || Lk < BR || Lq % BR || Lk % BR || B > 65535 || H > 65535 ||
      part < 0 || part > 1 || (d != 128 && d != 256 && (!is_f32 || d != 512)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tf32 = is_f32 != 0;
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
    } else {
      a.hk = h1;
      a.hv = h2;
    }
    // d = 256 and 512: clusters of d / 128 blocks, 32- and 16-row streamed tiles
    constexpr int TF32 = sm90::TF32;
    if (d == 128)
      return part == 0 ? sm90::launch_bwd_sm90<BCfg<256, 32, true, true, false, TF32>>(a, st)
                       : sm90::launch_bwd_sm90<BCfg<256, 32, true, false, false, TF32>>(a, st);
    if (d == 256)
      return part == 0 ? sm90::launch_bwd_sm90<BCfg<256, 32, true, true, false, TF32, 2>>(a, st)
                       : sm90::launch_bwd_sm90<BCfg<256, 32, true, false, false, TF32, 2>>(a, st);
    return part == 0 ? sm90::launch_bwd_sm90<BCfg<256, 16, true, true, false, TF32, 4>>(a, st)
                     : sm90::launch_bwd_sm90<BCfg<256, 16, true, false, false, TF32, 4>>(a, st);
  }
  if (d == 128)
    return part == 0 ? sm90::launch_bwd_sm90<BCfg<128, 64, true, true, false>>(a, st)
                     : sm90::launch_bwd_sm90<BCfg<128, 64, true, false, false>>(a, st);
  return part == 0 ? sm90::launch_bwd_sm90<BCfg<256, 32, true, true, false, sm90::SPLIT>>(a, st)
                   : sm90::launch_bwd_sm90<BCfg<256, 64, true, false, false, sm90::SPLIT>>(a, st);
}
