// One-pass GroupNorm (+ SiLU) over (B, L, C) for Hopper (sm_90a).
//
// Replaces sliders_tpu/ops/pallas_groupnorm.py::_gn_kernel (reached from
// _fused_group_norm_impl) and follows its formula:
//   - per group, the sum and the sum of squares of its L x C/G values in f32,
//     mean = sum / n, var = sumsq / n - mean^2 (n = L * C/G);
//   - per channel, a = rsqrt(var + eps) * gamma and b = beta - mean * rsqrt *
//     gamma in f32, each rounded to the input dtype;
//   - y = x * a + b in the input dtype (the product rounded, then the sum);
//   - with SiLU, y * round(sigmoid(y)) with the sigmoid taken in f32.
//
// What bounds it on the H100: it is a memory pass (a few operations per
// byte), so device memory and L2 bandwidth bound it. The TPU kernel held a
// batch's whole (L, C) slab in VMEM and took the sums on the MXU; here one
// block of 256 threads takes one (batch, group), reads its slab once for the
// sums (a block reduction, no atomics, so results repeat bit for bit) and
// once more for the apply pass, which at the UNet's shapes (at most 4096 x
// 80 values, 640 KB in bf16) mostly hits L2. A group's channels are C/G
// neighbouring values of each row, so the reads are strided by C: no
// vector loads yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int NTHREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// sum over the block; every thread gets the result
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < NTHREADS / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is reused by the next call
  return v;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    group_norm_kernel(const T* x, const float* gamma, const float* beta, T* y, int L, int C,
                      int G, float eps, int silu) {
  __shared__ float red[NTHREADS / 32];
  const int grp = blockIdx.x, b = blockIdx.y;
  const int cg = C / G;
  const long long base = (long long)b * L * C + (long long)grp * cg;
  const long long n = (long long)L * cg;
  // element i of the group is (row i / cg, channel i % cg); walk it by steps
  // of NTHREADS without a division per element
  const int dl = NTHREADS / cg, dc = NTHREADS % cg;

  float sum = 0.f, sumsq = 0.f;
  {
    long long l = threadIdx.x / cg;
    int c = threadIdx.x % cg;
    for (long long i = threadIdx.x; i < n; i += NTHREADS) {
      const float v = to_f(x[base + l * C + c]);
      sum += v;
      sumsq = fmaf(v, v, sumsq);
      l += dl;
      c += dc;
      if (c >= cg) {
        c -= cg;
        ++l;
      }
    }
  }
  sum = block_sum(sum, red);
  sumsq = block_sum(sumsq, red);
  const float mean = sum / (float)n;
  const float var = __fsub_rn(sumsq / (float)n, __fmul_rn(mean, mean));
  const float inv = rsqrtf(var + eps);
  const float mean_inv = __fmul_rn(mean, inv);

  long long l = threadIdx.x / cg;
  int c = threadIdx.x % cg;
  for (long long i = threadIdx.x; i < n; i += NTHREADS) {
    const int ch = grp * cg + c;
    const float gm = gamma[ch];
    const T a = from_f<T>(__fmul_rn(inv, gm));
    const T bb = from_f<T>(__fsub_rn(beta[ch], __fmul_rn(mean_inv, gm)));
    const long long off = base + l * C + c;
    const T t = from_f<T>(__fmul_rn(to_f(x[off]), to_f(a)));
    T out = from_f<T>(__fadd_rn(to_f(t), to_f(bb)));
    if (silu) {
      const float o = to_f(out);
      const T sig = from_f<T>(1.f / (1.f + __expf(-o)));
      out = from_f<T>(__fmul_rn(o, to_f(sig)));
    }
    y[off] = out;
    l += dl;
    c += dc;
    if (c >= cg) {
      c -= cg;
      ++l;
    }
  }
}

}  // namespace

// Returns the launch's CUDA error (0 on success). x, y: (B, L, C)
// contiguous in bf16 (is_f32 0) or f32; gamma, beta: (C,) f32; C a multiple
// of groups. The Python wrapper checks all of this.
extern "C" int group_norm_launch(const void* x, const void* gamma, const void* beta, void* y, int B,
                                 int L, int C, int groups, int is_f32, int silu, float eps,
                                 void* stream) {
  if (B < 1 || L < 1 || C < 1 || groups < 1 || C % groups != 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(groups, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  if (is_f32)
    group_norm_kernel<float><<<grid, NTHREADS, 0, st>>>(
        static_cast<const float*>(x), g, be, static_cast<float*>(y), L, C, groups, eps, silu);
  else
    group_norm_kernel<bf16><<<grid, NTHREADS, 0, st>>>(
        static_cast<const bf16*>(x), g, be, static_cast<bf16*>(y), L, C, groups, eps, silu);
  return static_cast<int>(cudaGetLastError());
}
