// 3x3 stride-1 SAME convolution on NHWC activations for Hopper (sm_90a),
// one implicit GEMM behind three entry points of the Python wrapper
// (ops/conv3x3.py):
//
//   conv3x3       y = conv(x, w) + bias                       (kernel #5)
//   epi_conv3x3   y = conv(x, w) + bias + temb[b] | residual  (kernel #7)
//   fused_conv3x3 y = conv(silu(x * a[b] + s[b]), w) + bias + temb[b] | residual
//                                                             (kernel #6)
//
// They replace sliders_tpu/ops/pallas_conv.py::_conv_kernel (reached from
// conv3x3), _epi_kernel (epi_conv3x3) and _fused_kernel (fused_conv3x3).
// M = B*H*W output pixels, N = output channels, K = 9*C. The accumulators
// are f32; bias and temb/residual are added in f32 and the result is rounded
// once, at the store, as the TPU kernels do. The fused prologue rounds its
// transformed input to the input dtype before the product (the TPU kernel's
// `pre_ref` scratch), and a tap outside the image reads zero in the
// normalised space (the TPU kernel's zero ring), never silu(s).
//
// Two kernels, chosen per call by `ops/conv3x3.plan`:
//   - `conv3x3_sm90_launch`, the Hopper mainloop of conv3x3_sm90.cuh (a TMA
//     halo tile per 128-byte channel chunk, a TMA weight ring, `wgmma` over
//     the nine taps), for every call TMA can take: bf16 on bf16 tensor
//     cores, f16 (`precision: fp16`) on the same plan with f16 operands;
//     f32 on TF32 tensor cores with error compensation (3xTF32: each
//     operand split into a TF32 hi and lo part, three products a step),
//     because the f32 products must match the exact-f32 plain version to
//     1e-5 and one TF32 pass keeps about 11 bits. What bounds it is the
//     tensor cores (f32: three TF32 passes against 495 TFLOP/s, still below
//     the 67 TFLOP/s FMA bound) and the weight boxes each tile reads from
//     L2; see the header's note. f32 weights are split once a call by
//     `tf32_split_launch` below into a (2, N, 3, 3, C) scratch.
//   - `conv3x3_launch`, the simple kernel ("generic") for what TMA cannot
//     take (C or x's strides not multiples of 16 bytes, addresses off 16
//     bytes, W < 8). It takes a 128 x 128 (bf16, f16) or 64 x 64 (f32) output
//     tile a block and loops over channel chunks of 32 (bf16, f16) or 16 (f32):
//     it stages the chunk's weights for all 9 taps once (read as they lie:
//     the port keeps every conv weight channels_last, (N, 3, 3, C) in
//     memory, so each tap's channels are one run), then for each tap
//     gathers the shifted input tile (zero where the tap leaves the image),
//     double-buffered through registers so that the next tap's loads
//     overlap this tap's products: mma.sync m16n8k16 in bf16 and f16 (8
//     warps, 64 x 32 outputs each), plain FMAs in f32 (4 x 4 outputs a thread). The
//     fused prologue's a and s of a chunk are held in registers across its
//     9 taps.

#include "conv3x3_sm90.cuh"

namespace {

// the element types of the dtype code the Python wrapper passes
enum : int { DT_BF16 = 0, DT_F32 = 1, DT_F16 = 2 };

// ws[t][nl][cl] = w[n0 + nl][t][c0 + cl] of the (N, 3, 3, C) weight, zero
// past N or C: each (n, tap)'s chunk of channels is one contiguous run
template <typename T>
__device__ __forceinline__ void load_w_2byte(const Params& p, T* ws, int n0, int c0) {
  const T* w = static_cast<const T*>(p.w);
  const long long row = 9LL * p.C;
  if (p.vec) {
    constexpr int PIECES = 9 * CK / 8;  // 16-byte pieces of one output channel's chunk
    for (int i = threadIdx.x; i < BN * PIECES; i += NTHREADS) {
      const int nl = i / PIECES, t = (i % PIECES) / (CK / 8), cl = (i % (CK / 8)) * 8;
      const int n = n0 + nl;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (n < p.N && c0 + cl < p.C)
        val = *reinterpret_cast<const uint4*>(w + n * row + t * p.C + c0 + cl);
      *reinterpret_cast<uint4*>(ws + t * (BN * SA) + nl * SA + cl) = val;
    }
  } else {
    for (int i = threadIdx.x; i < BN * 9 * CK; i += NTHREADS) {
      const int nl = i / (9 * CK), t = (i % (9 * CK)) / CK, cl = i % CK;
      const int n = n0 + nl;
      ws[t * (BN * SA) + nl * SA + cl] =
          (n < p.N && c0 + cl < p.C) ? w[n * row + t * p.C + c0 + cl] : from_f<T>(0.f);
    }
  }
}

// T: bf16 or f16
template <typename T, bool PRO>
__global__ void __launch_bounds__(NTHREADS) conv3x3_2byte(Params p) {
  constexpr bool F16 = conv_sm90::Elem<T>::F16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem);  // [9][BN][SA]: the chunk's weights by tap
  T* as = ws + 9 * BN * SA;            // [2][BM][SA]: one tap's input tile, double-buffered
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // this warp's outputs: rows wm*64.., columns wn*32..
  const int HW = p.H * p.W;
  const long long M = (long long)p.B * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the two (row, 8-channel group) slots of the input tile this thread loads
  int ar[2], ac[2], ab[2], ah[2], aw[2];
  bool av[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + j * NTHREADS;
    ar[j] = i / (CK / 8);
    ac[j] = (i % (CK / 8)) * 8;
    const long long m = m0 + ar[j];
    av[j] = m < M;
    const long long mm = av[j] ? m : 0;
    ab[j] = (int)(mm / HW);
    const int rem = (int)(mm % HW);
    ah[j] = rem / p.W;
    aw[j] = rem % p.W;
  }

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  uint4 pre[2];
  bool in[2];
  float fa[2][8], fs[2][8];  // the prologue's a and s of this thread's two slots (PRO only)
  for (int c0 = 0; c0 < p.C; c0 += CK) {
    load_w_2byte<T>(p, ws, n0, c0);
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // tap 0: (dy, dx) = (-1, -1)
      if (PRO) load_fold<T>(p, ab[j], c0 + ac[j], fa[j], fs[j]);
      pre[j] = load_x16<T>(p, av[j], ab[j], ah[j] - 1, aw[j] - 1, c0 + ac[j], in[j]);
      if (PRO && in[j]) prologue16<T>(pre[j], fa[j], fs[j]);
      *reinterpret_cast<uint4*>(as + ar[j] * SA + ac[j]) = pre[j];
    }
    __syncthreads();
    for (int t = 0; t < 9; ++t) {
      if (t < 8) {  // the next tap's loads are in flight during this tap's products
        const int dy = (t + 1) / 3 - 1, dx = (t + 1) % 3 - 1;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          pre[j] = load_x16<T>(p, av[j], ab[j], ah[j] + dy, aw[j] + dx, c0 + ac[j], in[j]);
      }
      const T* at = as + (t & 1) * (BM * SA);
      const T* wt = ws + t * (BN * SA);
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const T* base = at + (wm * 64 + mt * 16 + g) * SA + kk * 16 + t4 * 2;
          af[mt][0] = *reinterpret_cast<const uint32_t*>(base);
          af[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * SA);
          af[mt][2] = *reinterpret_cast<const uint32_t*>(base + 8);
          af[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * SA + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const T* bb = wt + (wn * 32 + nt * 8 + g) * SA + kk * 16 + t4 * 2;
          const uint32_t bfr[2] = {*reinterpret_cast<const uint32_t*>(bb),
                                   *reinterpret_cast<const uint32_t*>(bb + 8)};
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) mma_16816<F16>(acc[mt][nt], af[mt], bfr);
        }
      }
      if (t < 8) {  // the next tap's prologue runs after this tap's products are issued
        T* an = as + ((t + 1) & 1) * (BM * SA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (PRO && in[j]) prologue16<T>(pre[j], fa[j], fs[j]);
          *reinterpret_cast<uint4*>(an + ar[j] * SA + ac[j]) = pre[j];
        }
      }
      __syncthreads();
    }
  }

  T* y = static_cast<T*>(p.y);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * 64 + mt * 16 + g + half * 8;
      if (m >= M) continue;
      const int b = (int)(m / HW), rem = (int)(m % HW);
      const int h = rem / p.W, w = rem % p.W;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + t4 * 2;
        if (n >= p.N) continue;
        const float v0 = epilogue<T>(p, b, h, w, n, acc[mt][nt][half * 2]);
        if (n + 1 < p.N) {
          const float v1 = epilogue<T>(p, b, h, w, n + 1, acc[mt][nt][half * 2 + 1]);
          if ((p.N & 1) == 0) {
            *reinterpret_cast<uint32_t*>(y + m * p.N + n) = pack_pair<T>(v0, v1);
          } else {
            y[m * p.N + n] = from_f<T>(v0);
            y[m * p.N + n + 1] = from_f<T>(v1);
          }
        } else {
          y[m * p.N + n] = from_f<T>(v0);
        }
      }
    }
  }
}

// ws[t][cl][nl] = w[n0 + nl][t][c0 + cl] of the (N, 3, 3, C) weight, zero past N or C
__device__ __forceinline__ void load_w_f32(const Params& p, float* ws, int n0, int c0) {
  const float* w = static_cast<const float*>(p.w);
  const long long row = 9LL * p.C;
  if (p.vec) {
    constexpr int PIECES = 9 * CKF / 4;
    for (int i = threadIdx.x; i < BNF * PIECES; i += NTHREADS) {
      const int nl = i / PIECES, t = (i % PIECES) / (CKF / 4), cl = (i % (CKF / 4)) * 4;
      const int n = n0 + nl;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < p.N && c0 + cl < p.C)
        val = *reinterpret_cast<const float4*>(w + n * row + t * p.C + c0 + cl);
      const float e[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) ws[t * (CKF * BNF) + (cl + j) * BNF + nl] = e[j];
    }
  } else {
    for (int i = threadIdx.x; i < BNF * 9 * CKF; i += NTHREADS) {
      const int nl = i / (9 * CKF), t = (i % (9 * CKF)) / CKF, cl = i % CKF;
      const int n = n0 + nl;
      ws[t * (CKF * BNF) + cl * BNF + nl] =
          (n < p.N && c0 + cl < p.C) ? w[n * row + t * p.C + c0 + cl] : 0.f;
    }
  }
}

// the input tile transposed to [channel][row], so that a thread reads four
// neighbouring rows of one channel as one float4
__device__ __forceinline__ void store_a_f32(float* at, int r, int c, uint4 v) {
  const float* e = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) at[(c + j) * SAF + r] = e[j];
}

template <bool PRO>
__global__ void __launch_bounds__(NTHREADS) conv3x3_f32(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [9][CKF][BNF]
  float* as = ws + 9 * CKF * BNF;              // [2][CKF][SAF]
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;  // outputs rows tm*4.., columns tn*4..
  const int HW = p.H * p.W;
  const long long M = (long long)p.B * HW;
  const long long m0 = (long long)blockIdx.x * BMF;
  const int n0 = blockIdx.y * BNF;

  // this thread's (row, 4-channel group) slot of the input tile
  const int ar = threadIdx.x / (CKF / 4), ac = (threadIdx.x % (CKF / 4)) * 4;
  const long long m = m0 + ar;
  const bool av = m < M;
  const long long mm = av ? m : 0;
  const int ab = (int)(mm / HW), rem = (int)(mm % HW);
  const int ah = rem / p.W, aw = rem % p.W;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  float fa[4], fs[4];  // the prologue's a and s of this thread's slot (PRO only)
  bool in;
  for (int c0 = 0; c0 < p.C; c0 += CKF) {
    load_w_f32(p, ws, n0, c0);
    if (PRO) load_fold<float>(p, ab, c0 + ac, fa, fs);
    uint4 pre = load_x16<float>(p, av, ab, ah - 1, aw - 1, c0 + ac, in);
    if (PRO && in) prologue16<float>(pre, fa, fs);
    store_a_f32(as, ar, ac, pre);
    __syncthreads();
    for (int t = 0; t < 9; ++t) {
      if (t < 8) {
        const int dy = (t + 1) / 3 - 1, dx = (t + 1) % 3 - 1;
        pre = load_x16<float>(p, av, ab, ah + dy, aw + dx, c0 + ac, in);
      }
      const float* at = as + (t & 1) * (CKF * SAF);
      const float* wt = ws + t * (CKF * BNF);
#pragma unroll
      for (int c = 0; c < CKF; ++c) {
        const float4 a4 = *reinterpret_cast<const float4*>(at + c * SAF + tm * 4);
        const float4 b4 = *reinterpret_cast<const float4*>(wt + c * BNF + tn * 4);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (t < 8) {
        if (PRO && in) prologue16<float>(pre, fa, fs);
        store_a_f32(as + ((t + 1) & 1) * (CKF * SAF), ar, ac, pre);
      }
      __syncthreads();
    }
  }

  float* y = static_cast<float*>(p.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long mo = m0 + tm * 4 + i;
    if (mo >= M) continue;
    const int b = (int)(mo / HW), r = (int)(mo % HW);
    const int h = r / p.W, w = r % p.W;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n < p.N) y[mo * p.N + n] = epilogue<float>(p, b, h, w, n, acc[i][j]);
    }
  }
}

// hi = tf32(w), lo = tf32(w - hi) for each of the n values (tf32_split_launch),
// four a thread-step by 16-byte loads and stores where `vec` (n % 4 == 0 and
// both addresses on 16 bytes: every weight the f32 Hopper mainloop takes)
__device__ __forceinline__ void split_one(float v, float& hi, float& lo) {
  hi = sm90::tf32_rna(v);
  lo = sm90::tf32_rna(__fsub_rn(v, hi));
}

__global__ void tf32_split(const float* __restrict__ w, float* __restrict__ out, long long n,
                           int vec) {
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  if (vec) {
    const float4* w4 = reinterpret_cast<const float4*>(w);
    float4* hi4 = reinterpret_cast<float4*>(out);
    float4* lo4 = reinterpret_cast<float4*>(out + n);
    for (long long i = first; i < n / 4; i += step) {
      const float4 v = w4[i];
      float4 hi, lo;
      split_one(v.x, hi.x, lo.x);
      split_one(v.y, hi.y, lo.y);
      split_one(v.z, hi.z, lo.z);
      split_one(v.w, hi.w, lo.w);
      hi4[i] = hi;
      lo4[i] = lo;
    }
    return;
  }
  for (long long i = first; i < n; i += step) split_one(w[i], out[i], out[n + i]);
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, dim3 grid, size_t smem, cudaStream_t stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15u) == 0; }

// the Hopper mainloop's 2-byte instantiations (T: bf16 or f16) by BN and
// the prologue
template <typename T>
int launch_2byte(const Params& p, const conv_sm90::Plan& q, int BN, int prologue, int smem,
                 cudaStream_t st) {
  switch (BN * 2 + (prologue ? 1 : 0)) {
    case 256: return conv_sm90::launch<T, 128, false>(p, q, smem, st);
    case 257: return conv_sm90::launch<T, 128, true>(p, q, smem, st);
    case 320: return conv_sm90::launch<T, 160, false>(p, q, smem, st);
    case 321: return conv_sm90::launch<T, 160, true>(p, q, smem, st);
    case 512: return conv_sm90::launch<T, 256, false>(p, q, smem, st);
    // #6 takes BN <= 160: its consumers have 184 registers, short of a
    // 64 x 256 f32 accumulator's 128 and the A buffers
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the launch's CUDA error (0 on success). x: (B, H, W, C) with
// element strides xs_* and contiguous channels; w: (N, C, 3, 3) laid out
// channels_last, i.e. (N, 3, 3, C) in memory; bias (N,) and extra in x's
// dtype (`dtype` 0 bf16, 1 f32, 2 f16); extra is the temb (B, N) with row stride es_b (mode 1) or the
// residual (B, H, W, N) with strides es_* and contiguous channels (mode 2); a, s: (B, C) f32 contiguous when prologue
// is 1; y: (B, H, W, N) contiguous. The Python wrapper checks all of this.
extern "C" int conv3x3_launch(const void* x, const void* w, const void* bias, const void* extra,
                              const void* a, const void* s, void* y, int B, int H, int W, int C,
                              int N, int dtype, int mode, int prologue, long long xs_b,
                              long long xs_h, long long xs_w, long long es_b, long long es_h,
                              long long es_w, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || N < 1 || mode < MODE_NONE || mode > MODE_RESIDUAL ||
      (mode != MODE_NONE && extra == nullptr) || (prologue && (a == nullptr || s == nullptr)) ||
      dtype < DT_BF16 || dtype > DT_F16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool is_f32 = dtype == DT_F32;
  const int V = is_f32 ? 4 : 8;  // elements in 16 bytes
  Params p{x, w, bias, extra, static_cast<const float*>(a), static_cast<const float*>(s), y,
           B, H, W, C, N, mode, 0, xs_b, xs_h, xs_w, es_b, es_h, es_w};
  p.vec = C % V == 0 && xs_b % V == 0 && xs_h % V == 0 && xs_w % V == 0 && aligned16(x) &&
          aligned16(w);
  const long long M = (long long)B * H * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    const dim3 grid(static_cast<unsigned>((M + BMF - 1) / BMF), (N + BNF - 1) / BNF);
    const size_t smem = sizeof(float) * (9 * CKF * BNF + 2 * CKF * SAF);
    return prologue ? launch(conv3x3_f32<true>, p, grid, smem, st)
                    : launch(conv3x3_f32<false>, p, grid, smem, st);
  }
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), (N + BN - 1) / BN);
  const size_t smem = sizeof(bf16) * (9 * BN * SA + 2 * BM * SA);
  if (dtype == DT_F16)
    return prologue ? launch(conv3x3_2byte<f16, true>, p, grid, smem, st)
                    : launch(conv3x3_2byte<f16, false>, p, grid, smem, st);
  return prologue ? launch(conv3x3_2byte<bf16, true>, p, grid, smem, st)
                  : launch(conv3x3_2byte<bf16, false>, p, grid, smem, st);
}

// Returns the launch's CUDA error (0 on success). hi = tf32(w), lo =
// tf32(w - hi) of the n f32 values at w (round to nearest, ties away, as
// `sm90::tf32_rna`), written as out[0..n) and out[n..2n): the channels_last
// (N, 3, 3, C) weight becomes the (2, N, 3, 3, C) operand of the f32 Hopper
// mainloop. Plain version: ops/conv3x3.tf32_split_ref.
extern "C" int tf32_split_launch(const void* w, void* out, long long n, void* stream) {
  if (n < 1 || w == nullptr || out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = n % 4 == 0 && aligned16(w) && aligned16(out);
  const long long blocks = ((vec ? n / 4 : n) + 255) / 256;
  tf32_split<<<static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0,
               static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(w),
                                                    static_cast<float*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

// Returns the launch's CUDA error (0 on success). The Hopper mainloop on a
// tile plan (ops/conv3x3.plan): TR x TC output tiles (TR TC = 128), BN
// output channels a tile (bf16 and f16: 128, 160 or 256, and 128 or 160 with the
// prologue; f32: 128), `stages` weight
// stages, `smem` bytes of dynamic shared memory. The tensors are
// conv3x3_launch's, with C, x's strides and the addresses of x, w (and a,
// s) as TMA takes them: C and the strides multiples of 16 bytes, the
// addresses of 16 bytes. In f32 w is tf32_split_launch's (2, N, 3, 3, C)
// split of the weight. A plan that does not hold for the shape is refused
// (cudaErrorInvalidValue), never changed.
extern "C" int conv3x3_sm90_launch(const void* x, const void* w, const void* bias,
                                   const void* extra, const void* a, const void* s, void* y, int B,
                                   int H, int W, int C, int N, int dtype, int mode, int prologue,
                                   long long xs_b, long long xs_h, long long xs_w, long long es_b,
                                   long long es_h, long long es_w, int TR, int TC, int BN,
                                   int stages, int smem, void* stream) {
  using namespace conv_sm90;
  const bool is_f32 = dtype == DT_F32;
  const int V = is_f32 ? 4 : 8;  // elements in 16 bytes
  const bool tc_ok = TC == 8 || TC == 16 || TC == 32 || TC == 64 || TC == 128;
  const bool bn_ok = is_f32 ? BN == 128 : (BN == 128 || BN == 160 || (BN == 256 && !prologue));
  if (B < 1 || H < 1 || W < 1 || C < 1 || N < 1 || mode < MODE_NONE || mode > MODE_RESIDUAL ||
      (mode != MODE_NONE && extra == nullptr) || (prologue && (a == nullptr || s == nullptr)) ||
      C % V != 0 || xs_b % V != 0 || xs_h % V != 0 || xs_w % V != 0 || !aligned16(x) ||
      !aligned16(w) || (prologue && !(aligned16(a) && aligned16(s))) || !tc_ok ||
      TR * TC != 128 || !bn_ok || stages < 2 || stages > MAX_STAGES || dtype < DT_BF16 ||
      dtype > DT_F16 ||
      smem != plan_smem(TR, TC, BN, stages, is_f32 != 0) || smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // vec: the epilogue's 16-byte accesses (store_row16)
  const bool vec = N % 8 == 0 && aligned16(bias) && aligned16(y) &&
                   (mode == MODE_NONE ||
                    (aligned16(extra) && es_b % 8 == 0 &&
                     (mode == MODE_TEMB || (es_h % 8 == 0 && es_w % 8 == 0))));
  Params p{x, w, bias, extra, static_cast<const float*>(a), static_cast<const float*>(s), y,
           B, H, W, C, N, mode, vec ? 1 : 0, xs_b, xs_h, xs_w, es_b, es_h, es_w};
  Plan q;
  q.TR = TR;
  q.TC = TC;
  q.tc_log2 = __builtin_ctz(TC);
  q.stages = stages;
  q.halo_pad = halo_pad(TR, TC);
  q.TH = (H + TR - 1) / TR;
  q.TW = (W + TC - 1) / TC;
  q.NT = (N + BN - 1) / BN;
  const int ck = is_f32 ? Elem<float>::CK : Elem<bf16>::CK;
  q.KC = (C + ck - 1) / ck;
  const long long tiles = (long long)B * q.TH * q.TW * q.NT;
  if (tiles > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  q.tiles = static_cast<int>(tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    switch (BN * 2 + (prologue ? 1 : 0)) {
      case 256: return conv_sm90::launch<float, 128, false>(p, q, smem, st);
      case 257: return conv_sm90::launch<float, 128, true>(p, q, smem, st);
      // f32 takes BN = 128: a consumer holds two 64 x BN f32 accumulators
      // and the hi and lo A fragments of two half taps
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return dtype == DT_F16 ? launch_2byte<f16>(p, q, BN, prologue, smem, st)
                         : launch_2byte<bf16>(p, q, BN, prologue, smem, st);
}
