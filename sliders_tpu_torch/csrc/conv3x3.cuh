// Device helpers of the 3x3 conv kernels (conv3x3.cu): the parameter block,
// tile constants, mma.sync m16n8k16 bf16, element conversions, the input
// loader with the fused GroupNorm-affine + SiLU prologue, and the epilogue.
// Kept apart from sd_attention_common.cuh so that a change here cannot move
// the attention kernels' register allocation.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t4 = lane % 4):
//   A (16x16, row-major):  reg0 = A[g][2t4..+1], reg1 = A[g+8][2t4..+1],
//                          reg2 = A[g][2t4+8..+9], reg3 = A[g+8][2t4+8..+9]
//   B (16x8, "col"):       reg0 = B[2t4..+1][g],  reg1 = B[2t4+8..+9][g]
//   C (16x8, f32):         c0,c1 = C[g][2t4..+1], c2,c3 = C[g+8][2t4..+1]

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// epilogue modes: the TPU kernels' mode 'none' / 'temb' / 'residual'
constexpr int MODE_NONE = 0;
constexpr int MODE_TEMB = 1;
constexpr int MODE_RESIDUAL = 2;

constexpr int NTHREADS = 256;
// bf16: a 128 x 128 output tile, K in chunks of 32 channels x 9 taps;
// 8 warps as 2 (rows) x 4 (columns), 64 x 32 outputs each
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int CK = 32;
constexpr int SA = CK + 8;  // shared row stride (elements): 80 bytes, conflict-free fragments
// f32: a 64 x 64 output tile, chunks of 16 channels, 4 x 4 outputs a thread
constexpr int BMF = 64;
constexpr int BNF = 64;
constexpr int CKF = 16;
constexpr int SAF = BMF + 4;  // shared row stride of the transposed input tile

struct Params {
  const void* x;      // (B, H, W, C), channels contiguous, element strides xs_*
  const void* w;      // (N, C, 3, 3) channels_last: (N, 3, 3, C) in memory
  const void* bias;   // (N,), the input dtype
  const void* extra;  // temb (B, N) with row stride es_b, or residual (B, H, W, N) strides es_*
  const float* a;     // (B, C) f32 prologue scale (fused only)
  const float* s;     // (B, C) f32 prologue shift
  void* y;            // (B, H, W, N) contiguous
  int B, H, W, C, N;
  int mode;
  int vec;   // generic kernel: x and w allow 16-byte loads (C and x's strides multiples of
             // the vector width); Hopper mainloop: the epilogue's bias, extra and y do
  long long xs_b, xs_h, xs_w;
  long long es_b, es_h, es_w;
};

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// 16 bytes of channels c.. of input pixel (b, hh, ww): zero outside the
// image (the SAME padding), past C and for a tile row past M (`valid`
// false); `inside` tells whether a pixel was read.
template <typename T>
__device__ __forceinline__ uint4 load_x16(const Params& p, bool valid, int b, int hh, int ww,
                                          int c, bool& inside) {
  constexpr int V = 16 / sizeof(T);
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  inside = valid && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W && c < p.C;
  if (!inside) return out;
  const T* src = static_cast<const T*>(p.x) + b * p.xs_b + hh * p.xs_h + ww * p.xs_w + c;
  if (p.vec) {
    out = *reinterpret_cast<const uint4*>(src);
  } else {
    T* e = reinterpret_cast<T*>(&out);
    const int n = min(V, p.C - c);
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < n) e[j] = src[j];
  }
  return out;
}

// The fused prologue's scale and shift of batch b, channels c.. (16 bytes of
// T), held in registers for a whole channel chunk; zero past C, so that a
// channel past C stays silu(0 * 0 + 0) = 0.
template <typename T>
__device__ __forceinline__ void load_fold(const Params& p, int b, int c, float* a, float* s) {
  constexpr int V = 16 / sizeof(T);
  const long long base = (long long)b * p.C + c;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool ok = c + j < p.C;
    a[j] = ok ? p.a[base + j] : 0.f;
    s[j] = ok ? p.s[base + j] : 0.f;
  }
}

// The fused prologue on 16 bytes read from the image: each value becomes
// silu(x * a + s) in f32, rounded to the input dtype (the TPU kernel's
// `pre_ref` scratch). A tap outside the image is never passed here: it stays
// zero, as the padding lies in the normalised space.
template <typename T>
__device__ __forceinline__ void prologue16(uint4& v, const float* a, const float* s) {
  constexpr int V = 16 / sizeof(T);
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float u = __fadd_rn(__fmul_rn(to_f(e[j]), a[j]), s[j]);
    e[j] = from_f<T>(__fmul_rn(u, __frcp_rn(1.f + __expf(-u))));
  }
}

// bias + temb row or residual, added in f32 to one accumulator value of
// output (m = pixel (b, h, w), n)
template <typename T>
__device__ __forceinline__ float epilogue(const Params& p, int b, int h, int w, int n, float v) {
  v += to_f(static_cast<const T*>(p.bias)[n]);
  if (p.mode == MODE_TEMB)
    v += to_f(static_cast<const T*>(p.extra)[b * p.es_b + n]);
  else if (p.mode == MODE_RESIDUAL)
    v += to_f(static_cast<const T*>(p.extra)[b * p.es_b + h * p.es_h + w * p.es_w + n]);
  return v;
}

}  // namespace
