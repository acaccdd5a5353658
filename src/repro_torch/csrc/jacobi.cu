// 5-point Jacobi stencil over a batch of tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   repro/kernels/jacobi/kernel.py:22  _jacobi_kernel (body)
//   repro/kernels/jacobi/kernel.py:42  jacobi_step (entry)
// and, on the stencil app's path, the XLA-compiled tile update
// repro/core/overdecomp.py:73 jacobi_tile_step, vmapped over a PE's tiles
// (:159).  Both compute the same function:
//
//   out[t][r][c] = 0.25 * (((up + down) + left) + right)
//
// for every tile id t of a list, over tiles src (T, h, w).  The halo of a
// tile edge is the facing edge of its neighbour (nbr (T, 4): up, down,
// left, right; -1 is the boundary): a missing up-neighbour gives the hot
// edge 1.0, any other missing neighbour 0.0.  jacobi_step(grid) is the
// case T = 1 with every neighbour missing (ids and nbr null).
//
// Numerics: the plain PyTorch version rounds after every op, so the kernel
// does too.  float32: __fadd_rn in that order and __fmul_rn (no FMA
// contraction, no fast-math); the result is the plain version's, bit for
// bit.  bf16: each add takes both operands to float, adds once and rounds
// to the nearest bf16, as torch's bf16 elementwise ops do on the card; the
// product with 0.25 is exact.
//
// Bound: bytes.  A sweep reads each input element once and writes each
// output once, 2 * h * w * itemsize per tile and 4 operations per element:
// at 16384 x 16384 float32 that is 2 GiB, 0.64 ms at 3.35 TB/s, against
// 1.07 GFLOP, 0.016 ms at the 67 TFLOP/s of float32.
//
// What the simple design does about it:
// * Threads run along w (256 columns a CTA), so every row access of a warp
//   is one coalesced 128-byte line (64 bytes in bf16).
// * Each thread walks down kRows rows of its column and carries the rows
//   above and at the current position in registers: of the five values of
//   a point it loads only the row below (from device memory) and its left
//   and right neighbours (the lines its warp has just loaded, from L1).
// * Halos are read straight from the neighbour tiles of src, the pre-step
//   buffer: the caller writes dst, a second buffer (src and dst must not
//   overlap).  The left and right halos are strided column reads, one
//   element a row, by the first and last thread of the tile's row only.
// * No shared memory, no tensor cores: a stencil has nothing for them.
//
// The C entry launches on the caller's stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.
// jacobi_tiles_load loads the kernel onto the card ahead of the first
// launch, which CUDA's lazy loading would otherwise make slower than the
// rest (the tile runtime times every launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // columns of one CTA
constexpr int kRows = 16;      // rows one thread walks down

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float quarter(float a) {
    return __fmul_rn(0.25f, a);
  }
  static __device__ __forceinline__ float of(float v) { return v; }
};

template <>
struct Arith<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
  static __device__ __forceinline__ __nv_bfloat16 quarter(__nv_bfloat16 a) {
    return __float2bfloat16_rn(__fmul_rn(0.25f, __bfloat162float(a)));
  }
  static __device__ __forceinline__ __nv_bfloat16 of(float v) {
    return __float2bfloat16_rn(v);
  }
};

// grid (ceil(w / kThreads), ceil(h / kRows), n); blockIdx.z indexes ids.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    jacobi_tiles_kernel(const T* __restrict__ src, T* __restrict__ dst,
                        const int* __restrict__ ids,
                        const int* __restrict__ nbr, int h, int w) {
  using A = Arith<T>;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= w) return;
  const int r0 = blockIdx.y * kRows;
  const int r1 = min(r0 + kRows, h);
  const int t = ids != nullptr ? ids[blockIdx.z] : (int)blockIdx.z;
  int n_up = -1, n_down = -1, n_left = -1, n_right = -1;
  if (nbr != nullptr) {
    const int* nb = nbr + 4 * (size_t)t;
    n_up = nb[0];
    n_down = nb[1];
    n_left = nb[2];
    n_right = nb[3];
  }
  const size_t plane = (size_t)h * w;
  const T* tile = src + t * plane;
  T* out = dst + t * plane;
  const T zero = A::of(0.0f);

  T up;
  if (r0 > 0)
    up = tile[(size_t)(r0 - 1) * w + c];
  else
    up = n_up >= 0 ? src[n_up * plane + (size_t)(h - 1) * w + c] : A::of(1.0f);
  T mid = tile[(size_t)r0 * w + c];
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const size_t row = (size_t)r * w;
    T down;
    if (r + 1 < h)
      down = tile[row + w + c];
    else
      down = n_down >= 0 ? src[n_down * plane + c] : zero;
    T left;
    if (c > 0)
      left = tile[row + c - 1];
    else
      left = n_left >= 0 ? src[n_left * plane + row + (w - 1)] : zero;
    T right;
    if (c + 1 < w)
      right = tile[row + c + 1];
    else
      right = n_right >= 0 ? src[n_right * plane + row] : zero;
    out[row + c] = A::quarter(A::add(A::add(A::add(up, down), left), right));
    up = mid;
    mid = down;
  }
}

template <typename T>
int launch(const void* src, void* dst, const int* ids, const int* nbr, int n,
           int h, int w, cudaStream_t stream) {
  const dim3 grid((w + kThreads - 1) / kThreads, (h + kRows - 1) / kRows, n);
  jacobi_tiles_kernel<T><<<grid, dim3(kThreads), 0, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), ids, nbr, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

// One sweep of the n tiles ids[0..n) of src (T, h, w) into the same tiles
// of dst.  ids (n,) and nbr (T, 4) are int32 on the card; both null means
// T = n = 1 with every neighbour missing (one global sweep).  bf16 != 0
// selects bfloat16, else float32.  Returns 0 on success, a cudaError_t
// from the launch, or -1 for shapes the grid cannot cover.
extern "C" int jacobi_tiles_launch(const void* src, void* dst,
                                   const void* ids, const void* nbr, int n,
                                   int h, int w, int bf16, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || n > 65535 ||
      (h + kRows - 1) / kRows > 65535)
    return -1;
  const int* idp = static_cast<const int*>(ids);
  const int* nbp = static_cast<const int*>(nbr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(src, dst, idp, nbp, n, h, w, s);
  return launch<float>(src, dst, idp, nbp, n, h, w, s);
}

// Loads both instantiations onto the current device.  Returns 0 or a
// cudaError_t.
extern "C" int jacobi_tiles_load() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, jacobi_tiles_kernel<float>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, jacobi_tiles_kernel<__nv_bfloat16>);
  return (int)err;
}
