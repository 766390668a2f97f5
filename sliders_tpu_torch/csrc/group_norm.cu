// GroupNorm (+ SiLU) over (B, L, C) for Hopper (sm_90a), in two coalesced
// passes.
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
// What bounds it on the H100: device memory (x read once and y written
// once, 2 B L C itemsize bytes) and, in bf16, the conversions that round
// each value four times with SiLU (they issue at a quarter of the FMA
// rate: values are rounded in pairs, one packed conversion each, and
// stored without another). The TPU kernel held a batch's whole (L, C) slab
// in VMEM; here blocks own chunks of `rows` rows of one batch across all C
// (ops/group_norm.plan: about four blocks an SM a pass):
//   - gn_stats: thread (rr, j) sums 16-byte vector j (V channels) of rows
//     rr, rr + rpi, ... of the chunk in f32 (neighbouring threads on
//     neighbouring vectors, four rows in flight), the block folds the sums
//     in a fixed order (over rr, then the group's channels) into each
//     group's partial and writes it to an f32 scratch (B, chunks, G, 2);
//   - gn_apply (a programmatic dependent launch: its blocks start under
//     gn_stats's tail and wait for its end): the same chunks in the reverse
//     order, so that the first blocks read the rows gn_stats read last,
//     from L2; each block folds its batch's partials over the chunks in
//     order (no atomics: two launches give the same bits), forms its
//     channels' a and b, and writes y by 16-byte vectors, reading x and
//     writing y as evict_first.
// Reading x once (each chunk kept in shared memory from its sums to its
// output, a persistent grid waiting on each batch's chunks), batch groups
// small enough for L2 between the passes, and eight blocks an SM all ran
// slower on the H100, and an L2 evict_last hint on the first pass's loads
// no faster (PERF.md, section 6).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// v rounded to the storage type T and back
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a and b rounded to T and back in place: bf16 by one packed conversion
// (conversions issue at a quarter of the FMA rate, and the apply pass takes
// four a value with SiLU) and two integer moves back
template <typename T>
__device__ __forceinline__ void rnd2(float& a, float& b);
template <>
__device__ __forceinline__ void rnd2<float>(float&, float&) {}
template <>
__device__ __forceinline__ void rnd2<bf16>(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const uint32_t w = reinterpret_cast<const uint32_t&>(h);
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xFFFF0000u);
}

// 16 bytes of T as V floats
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int V = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  }
  __device__ static void load_last(const float* p, float* v) {  // read once more: evict first
    const float4 u = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  }
  // values already rounded to T
  __device__ static void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Vec<bf16> {
  static constexpr int V = 8;
  __device__ static void unpack(const uint4& u, float* v) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  __device__ static void load(const bf16* p, float* v) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  __device__ static void load_last(const bf16* p, float* v) {
    unpack(__ldcs(reinterpret_cast<const uint4*>(p)), v);
  }
  // values already rounded to bf16: their high halves, no conversion
  __device__ static void store(bf16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = __byte_perm(__float_as_uint(v[2 * i]), __float_as_uint(v[2 * i + 1]), 0x7632);
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

// Each group's partial sum and sum of squares over the `nrows` rows of C
// values at src -> out[g] as (sum, sumsq); red:
// rpi * C float2 of shared memory; C / V * rpi threads
template <typename T>
__device__ __forceinline__ void chunk_stats(const T* src, int nrows, float* out, float2* red,
                                            int C, int G, int rpi) {
  constexpr int V = Vec<T>::V;
  const int nv = C / V, j = threadIdx.x % nv, rr = threadIdx.x / nv;
  const T* xb = src + j * V;
  float s[V], q[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = q[e] = 0.f;
  auto add = [&](const float* v) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s[e] += v[e];
      q[e] = fmaf(v[e], v[e], q[e]);
    }
  };
  int r = rr;
  // four rows in flight, summed in row order
  for (; r + 3 * rpi < nrows; r += 4 * rpi) {
    float v[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) Vec<T>::load(xb + (long long)(r + u * rpi) * C, v[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) add(v[u]);
  }
  for (; r < nrows; r += rpi) {
    float v[V];
    Vec<T>::load(xb + (long long)r * C, v);
    add(v);
  }
#pragma unroll
  for (int e = 0; e < V; ++e) red[rr * C + j * V + e] = make_float2(s[e], q[e]);
  __syncthreads();
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float gs = 0.f, gq = 0.f;
    for (int k = 0; k < rpi; ++k)
#pragma unroll 4
      for (int c = g * cg; c < (g + 1) * cg; ++c) {
        const float2 t = red[k * C + c];
        gs += t.x;
        gq += t.y;
      }
    *reinterpret_cast<float2*>(out + 2 * g) = make_float2(gs, gq);
  }
}

// each group's mean and rsqrt(var + eps) -> gstat, from the partials of a
// batch's nch chunks (part: [nch][G][2]) summed in chunk order
__device__ __forceinline__ void fold_stats(const float* part, int nch, int L, int C, int G,
                                           float eps, float2* gstat) {
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float sum = 0.f, sumsq = 0.f;
#pragma unroll 16
    for (int k = 0; k < nch; ++k) {
      const float2 t = __ldcg(reinterpret_cast<const float2*>(part + ((long long)k * G + g) * 2));
      sum += t.x;
      sumsq += t.y;
    }
    const float n = (float)((long long)L * cg);
    const float mean = sum / n;
    const float var = __fsub_rn(sumsq / n, __fmul_rn(mean, mean));
    gstat[g] = make_float2(mean, rsqrtf(var + eps));
  }
  __syncthreads();
}

// y of the `nrows` rows at src (x's last read) -> dst, from gstat
template <typename T>
__device__ __forceinline__ void chunk_apply(const T* src, T* dst, int nrows, const float* gamma,
                                            const float* beta, const float2* gstat, int C, int G,
                                            int rpi, int silu) {
  constexpr int V = Vec<T>::V;
  const int nv = C / V, j = threadIdx.x % nv, rr = threadIdx.x / nv;
  const int cg = C / G;
  // this thread's channels j V .. j V + V - 1: a and b rounded to T
  float a[V], sh[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int ch = j * V + e;
    const float2 st = gstat[ch / cg];
    const float gm = gamma[ch], mean_inv = __fmul_rn(st.x, st.y);
    a[e] = rnd<T>(__fmul_rn(st.y, gm));
    sh[e] = rnd<T>(__fsub_rn(beta[ch], __fmul_rn(mean_inv, gm)));
  }
  // y = x a + b in T; SiLU: y round(sigmoid(y)), the sigmoid in f32 (a
  // reciprocal of 1 + e^-y within an ulp or two); values rounded in pairs
  auto apply = [&](float* v) {
#pragma unroll
    for (int e = 0; e < V; e += 2) {
      float o0 = __fmul_rn(v[e], a[e]), o1 = __fmul_rn(v[e + 1], a[e + 1]);
      rnd2<T>(o0, o1);
      o0 = __fadd_rn(o0, sh[e]);
      o1 = __fadd_rn(o1, sh[e + 1]);
      rnd2<T>(o0, o1);
      if (silu) {
        float s0 = __fdividef(1.f, 1.f + __expf(-o0)), s1 = __fdividef(1.f, 1.f + __expf(-o1));
        rnd2<T>(s0, s1);
        o0 = __fmul_rn(o0, s0);
        o1 = __fmul_rn(o1, s1);
        rnd2<T>(o0, o1);
      }
      v[e] = o0;
      v[e + 1] = o1;
    }
  };
  auto load = [&](int r, float* v) { Vec<T>::load_last(src + (long long)r * C + j * V, v); };
  int r = rr;
  for (; r + 3 * rpi < nrows; r += 4 * rpi) {
    float v[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) load(r + u * rpi, v[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      apply(v[u]);
      Vec<T>::store(dst + (long long)(r + u * rpi) * C + j * V, v[u]);
    }
  }
  for (; r < nrows; r += rpi) {
    float v[V];
    load(r, v);
    apply(v);
    Vec<T>::store(dst + (long long)r * C + j * V, v);
  }
}

// The partials of chunk blockIdx.x of batch blockIdx.y; C / V * rpi
// threads, dynamic shared memory rpi C float2
template <typename T>
__global__ void __launch_bounds__(1024)
    gn_stats(const T* x, float* part, int L, int C, int G, int rows, int rpi) {
  extern __shared__ float2 red[];
  // gn_apply may launch now: its blocks take the SMs this grid leaves and
  // wait for its end before reading the partials
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int c = blockIdx.x, b = blockIdx.y, r0 = c * rows;
  chunk_stats<T>(x + ((long long)b * L + r0) * C, min(rows, L - r0),
                 part + ((long long)b * gridDim.x + c) * G * 2, red, C, G, rpi);
}

// then y of chunk (chunks - 1 - blockIdx.x) of batch (B - 1 - blockIdx.y),
// the chunks gn_stats read last first; dynamic shared memory G float2
template <typename T>
__global__ void __launch_bounds__(1024)
    gn_apply(const T* x, const float* part, const float* gamma, const float* beta, T* y, int L,
             int C, int G, int rows, int rpi, float eps, int silu) {
  extern __shared__ float2 gstat[];
  const int nch = gridDim.x, c = nch - 1 - blockIdx.x, b = gridDim.y - 1 - blockIdx.y;
  const int r0 = c * rows;
  const long long off = ((long long)b * L + r0) * C;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // gn_stats has ended: the partials
  fold_stats(part + (long long)b * nch * G * 2, nch, L, C, G, eps, gstat);
  chunk_apply<T>(x + off, y + off, min(rows, L - r0), gamma, beta, gstat, C, G, rpi, silu);
}

template <typename T>
int launch(const void* xv, const float* gamma, const float* beta, void* yv, float* part, int B,
           int L, int C, int G, int rows, int rpi, int silu, float eps, cudaStream_t st) {
  constexpr int V = Vec<T>::V;
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const int threads = C / V * rpi, nch = (L + rows - 1) / rows;
  if (C % V || threads > 1024 || rpi < 1 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t red = (size_t)rpi * C * sizeof(float2);
  cudaError_t err;
  if (red > 48 * 1024 &&
      (err = cudaFuncSetAttribute(gn_stats<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)red)) != cudaSuccess)
    return static_cast<int>(err);
  const dim3 grid(nch, B);
  gn_stats<T><<<grid, threads, red, st>>>(x, part, L, C, G, rows, rpi);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // gn_apply as a programmatic dependent launch: it launches under
  // gn_stats's tail and waits for its end (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = G * sizeof(float2);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, gn_apply<T>, x, static_cast<const float*>(part), gamma,
                                beta, y, L, C, G, rows, rpi, eps, silu)) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the launches' CUDA error (0 on success). x, y: (B, L, C)
// contiguous and 16-byte aligned in bf16 (is_f32 0) or f32, C a multiple of
// groups and of the 16-byte vector (8 bf16, 4 f32 values); gamma, beta:
// (C,) f32; part: B * ceil(L / rows) * groups * 2 floats of partials; the
// plan (rows a block, rpi rows a pass of its C / V * rpi threads) from
// ops/group_norm.plan. The Python wrapper checks all of this.
extern "C" int group_norm_launch(const void* x, const void* gamma, const void* beta, void* y,
                                 void* part, int B, int L, int C, int groups, int is_f32,
                                 int silu, float eps, int rows, int rpi, void* stream) {
  if (B < 1 || L < 1 || C < 1 || groups < 1 || C % groups != 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* pt = static_cast<float*>(part);
  return is_f32 ? launch<float>(x, g, be, y, pt, B, L, C, groups, rows, rpi, silu, eps, st)
                : launch<bf16>(x, g, be, y, pt, B, L, C, groups, rows, rpi, silu, eps, st);
}
