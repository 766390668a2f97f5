// Device helpers shared by the attention kernels' Hopper mainloops
// (attention_sm90.cuh, attention_bwd_sm90.cuh, attention_fwd_tf32.cuh) and
// flash_attention.cu's f32 FMA kernels: the strides, the bf16 and f16 packing and
// the reductions over the four threads (lanes 4 g .. 4 g + 3) that share
// the rows g and g + 8 of a wgmma accumulator.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <math.h>

namespace {

struct Strides {
  long long b, h, l;
};

typedef __nv_bfloat16 bf16;

// two floats -> one register of two bf16 (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two floats -> one register of two f16 (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// pack_f16 where F16, else pack_bf16
template <bool F16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (F16)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// reduce over the four threads that share one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
