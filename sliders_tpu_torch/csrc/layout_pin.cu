// The layout pin: a contiguous copy of a (B, L, C) tensor, for Hopper (sm_90a).
//
// Replaces sliders_tpu/ops/basic.py::_layout_pin_call (its inline _kernel),
// an identity the TPU build puts at the UNet's transformer boundaries so
// that XLA cannot carry a conv's L-minor layout into the token tensors. The
// output is row-major (B, L, C) and holds the input's bits: no arithmetic,
// so 2-byte and 4-byte elements are copied as raw 16- and 32-bit words.
//
// What bounds it on the H100: it does no arithmetic, so device memory bounds
// it: every byte is read once and written once (2 x bytes / 3.35 TB/s). The
// TPU kernel copies one (1, L, C) block per batch row through VMEM; here the
// schedule follows the input's strides instead, so that reads and writes
// both stay coalesced:
//   - channel-contiguous rows (stride(C) == 1) whose starts and width are
//     multiples of 16 bytes (a contiguous tensor among them): a grid-stride
//     copy of 16-byte vectors;
//   - channel-major input (stride(L) == 1, the (B, H, W, C) view of an NCHW
//     buffer): 32 x 32 tiles transposed through shared memory, padded so the
//     column reads hit distinct banks;
//   - anything else: an element-wise gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COPY_THREADS = 256;
constexpr int MAX_COPY_BLOCKS = 132 * 32;  // grid-stride beyond 32 blocks per SM
constexpr int TILE = 32;
constexpr int TILE_ROWS = 8;  // a (32, 8) block moves a 32 x 32 tile

__host__ __device__ inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// rows of `cv` 16-byte vectors, row (b, l) starting at byte b * sb + l * sl
// (strides in bytes here)
__global__ void __launch_bounds__(COPY_THREADS)
    layout_pin_rows16(const char* __restrict__ x, uint4* __restrict__ y, long long n, int cv,
                      long long L, long long sb, long long sl) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / cv;
    const int v = static_cast<int>(i - r * cv);
    const long long b = r / L, l = r - b * L;
    y[i] = reinterpret_cast<const uint4*>(x + b * sb + l * sl)[v];
  }
}

// channel-major input: x[b, l, c] at b * sb + c * sc + l (strides in
// elements); tile (l0, c0) of batch row b is read along l and written along c
template <typename T>
__global__ void __launch_bounds__(TILE * TILE_ROWS)
    layout_pin_transpose(const T* __restrict__ x, T* __restrict__ y, int L, int C, long long sb,
                         long long sc) {
  // 32-bit words: one pad element; 16-bit: two, so that column j of the tile
  // starts j * 17 words in and a warp's column reads hit 32 distinct banks
  __shared__ T tile[TILE][TILE + 4 / sizeof(T)];
  const int l0 = blockIdx.x * TILE, c0 = blockIdx.y * TILE;
  const long long b = blockIdx.z;
  const T* xb = x + b * sb;
  T* yb = y + b * (long long)L * C;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int j = ty; j < TILE; j += TILE_ROWS) {
    const int c = c0 + j, l = l0 + tx;
    if (c < C && l < L) tile[j][tx] = xb[c * sc + l];
  }
  __syncthreads();
#pragma unroll
  for (int j = ty; j < TILE; j += TILE_ROWS) {
    const int l = l0 + j, c = c0 + tx;
    if (l < L && c < C) yb[(long long)l * C + c] = tile[tx][j];
  }
}

// any other strides: batch row blockIdx.y, element by element
template <typename T>
__global__ void __launch_bounds__(COPY_THREADS)
    layout_pin_gather(const T* __restrict__ x, T* __restrict__ y, long long L, long long C,
                      long long sb, long long sl, long long sc) {
  const long long b = blockIdx.y;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < L * C;
       i += (long long)gridDim.x * blockDim.x) {
    const long long l = i / C, c = i - l * C;
    y[b * L * C + i] = x[b * sb + l * sl + c * sc];
  }
}

int copy_blocks(long long n) {
  const long long blocks = cdiv(n, COPY_THREADS);
  return static_cast<int>(blocks < MAX_COPY_BLOCKS ? blocks : MAX_COPY_BLOCKS);
}

template <typename T>
void launch_typed(const void* x, void* y, int B, int L, int C, long long sb, long long sl,
                  long long sc, cudaStream_t st) {
  if (sl == 1 && L > 1) {
    const dim3 grid(static_cast<unsigned>(cdiv(L, TILE)), static_cast<unsigned>(cdiv(C, TILE)),
                    B),
        block(TILE, TILE_ROWS);
    layout_pin_transpose<T><<<grid, block, 0, st>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                                   L, C, sb, sc);
  } else {
    const dim3 grid(copy_blocks((long long)L * C), B);
    layout_pin_gather<T><<<grid, COPY_THREADS, 0, st>>>(static_cast<const T*>(x),
                                                       static_cast<T*>(y), L, C, sb, sl, sc);
  }
}

}  // namespace

// Returns the launch's CUDA error (0 on success). x: (B, L, C) with element
// strides sb, sl, sc (none negative) and elem_bytes 2 or 4; y: a contiguous
// (B, L, C) buffer of the same element size, 16-byte aligned. The Python
// wrapper (ops/layout_pin.py) checks shapes, types and devices.
extern "C" int layout_pin_launch(const void* x, void* y, int B, int L, int C, long long sb,
                                 long long sl, long long sc, int elem_bytes, void* stream) {
  if (B < 1 || L < 1 || C < 1 || B > 65535 || (elem_bytes != 2 && elem_bytes != 4) ||
      sb < 0 || sl < 0 || sc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long row_bytes = (long long)C * elem_bytes;
  const bool rows16 = sc == 1 && row_bytes % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      (sl * elem_bytes) % 16 == 0 && (sb * elem_bytes) % 16 == 0;
  if (rows16) {
    const long long n = (long long)B * L * (row_bytes / 16);
    layout_pin_rows16<<<copy_blocks(n), COPY_THREADS, 0, st>>>(
        static_cast<const char*>(x), static_cast<uint4*>(y), n, static_cast<int>(row_bytes / 16),
        L, sb * elem_bytes, sl * elem_bytes);
  } else if (elem_bytes == 2) {
    launch_typed<uint16_t>(x, y, B, L, C, sb, sl, sc, st);
  } else {
    launch_typed<uint32_t>(x, y, B, L, C, sb, sl, sc, st);
  }
  return static_cast<int>(cudaGetLastError());
}
