// Mamba2 SSD intra-chunk block (state-space duality), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   repro/kernels/ssd/kernel.py:25  _ssd_kernel (body)
//   repro/kernels/ssd/kernel.py:54  ssd_intra_chunk (entry)
//
// What it computes, in float32, for every (batch, chunk c, head hh) over
// the chunk's l positions (the same function, not the TPU's blocks):
//
//   y[i]  = sum_{j <= i} (C_i . B_j) * exp(dAcs_i - dAcs_j) * dt_j * x_j
//   state = sum_j exp(dAcs_{l-1} - dAcs_j) * dt_j * x_j (outer) B_j
//
//   x      (b, nc, l, h, p)   dt, dAcs (b, nc, l, h)   B, C (b, nc, l, n)
//   y      (b, nc, l, h, p)   state    (b, nc, h, p, n)
//
// B and C have one group, shared by every head.
//
// Bound: float32 operations.  The function needs, per (b, c), the causal
// half of C.B^T (l(l+1)/2 * n multiply-adds, shared by the heads), and per
// head the causal half of att @ xdt (l(l+1)/2 * p) and the state product
// (l * p * n).  At mamba2-780m's 256-token chunk (h 48, p 64, n 128) that
// is ~0.41 GFLOP against ~8.2 MB of inputs and outputs: about 6 us at
// the 67 TFLOP/s of FFMA and 2.5 us at 3.35 TB/s.  The reference's tests
// hold the kernel to 1e-4, so products stay float32 FFMA with float32
// sums (no TF32 tensor cores).
//
// What the simple design does about it:
// * The TPU kernel keeps a whole l x l score matrix of one (b, c, h) in
//   VMEM.  At l = 256 that is 256 KB of float32, more than an SM's shared
//   memory.  Here one CTA takes one (b, c, head, 64-row tile of i) and
//   streams the 64-column tiles of j up to the diagonal only (causal):
//   the S = C_i . B_j^T tile and the y accumulator live in registers
//   (4 x 4 per thread), the decayed score tile goes through shared memory
//   once, transposed, and is multiplied by the tile's x * dt.
// * The decay exp(dAcs_i - dAcs_j) is applied through a select on j <= i
//   *before* it meets the score: above the diagonal the exponent is
//   positive and can overflow, and inf * 0 would be NaN.
// * The state product is a small GEMM (p x n, reduced over l); its
//   64 x 64 tiles are extra CTAs of the same grid (blockIdx.y past the
//   i tiles), so they run beside the y tiles in one launch.  The y tiles
//   with the most j tiles are issued first.
// * Every inner loop reads two 16-byte vectors of shared memory for 16
//   FFMAs; shared rows of transposed tiles are padded (68 floats) so
//   vector reads stay aligned.
// * Tiles are filled with 4-byte cp.async copies (transposing where the
//   products want it), every thread issuing all of its copies before it
//   waits: the first version loaded one float at a time, each waiting
//   out a full memory latency, and that set a floor of ~0.015-0.02 ms.
//   x * dt (and the state's decay weight) are applied in shared memory
//   after the copies land, in the plain version's order.
// * Warps whose rows all lie at or past l skip the products (at l = 16
//   three of every four).
// * C.B^T is recomputed per head (as on the TPU).  Computing it once per
//   chunk for all heads, tensor cores and TMA are for a later version.
//
// The C entry launches on the caller's stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx)
constexpr int kTile = 64;      // rows and columns of every tile
constexpr int kPad = 68;       // padded row of a transposed tile, floats
constexpr int kMaxP = 128;     // head_dim: at most two 64-column groups
constexpr int kMaxN = 256;     // ssm_state

struct Dims {
  int l, h, p, n;
  int n_itiles;  // y tiles per (b, c, head)
  int n_ntiles;  // state tiles along n
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Asynchronous 4-byte copy global -> shared; zero-fills when !valid
// (src-size 0: nothing is read, `src` only has to be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Rows r0 .. r0+63 of a row-major (rows, n) matrix into shared memory
// transposed, dst[k * kPad + rr]; rows at or past `rows` read as 0.  The
// copies are asynchronous: every thread issues all of its copies before
// any of them has to land (cp_async_wait_all).
__device__ __forceinline__ void fill_transposed(float* dst,
                                                const float* __restrict__ src,
                                                int r0, int rows, int n) {
  int rr = threadIdx.x / n, k = threadIdx.x % n;
  const int drr = kThreads / n, dk = kThreads % n;
  while (rr < kTile) {
    const int r = r0 + rr;
    cp_async4(dst + k * kPad + rr, src + (size_t)(r < rows ? r : 0) * n + k,
              r < rows);
    k += dk;
    rr += drr;
    if (k >= n) {
      k -= n;
      ++rr;
    }
  }
}

// Shared-memory floats of a y tile and of a state tile; the launch takes
// the larger.
__host__ __device__ inline size_t y_floats(int n, int pg) {
  return (size_t)2 * n * kPad + (size_t)kTile * pg * kTile +
         (size_t)kTile * kPad + 3 * kTile;
}
__host__ __device__ inline size_t state_floats() {
  return (size_t)2 * kTile * kTile + 2 * kTile;
}

// y rows i0 .. i0+63 of head hh of chunk bc.  PG = 64-column groups of p.
template <int PG>
__device__ void y_tile(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ dacs,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm, float* __restrict__ y,
                       int bc, int hh, int it, const Dims& d, float* smem) {
  constexpr int PW = PG * kTile;
  const int l = d.l, h = d.h, p = d.p, n = d.n;
  float* Cs = smem;                // [n][kPad]   Cs[k][ii] = C[i0+ii][k]
  float* Bs = Cs + n * kPad;       // [n][kPad]   Bs[k][jj] = B[j0+jj][k]
  float* Xs = Bs + n * kPad;       // [kTile][PW] x[j][hh][:] * dt[j][hh]
  float* At = Xs + kTile * PW;     // [kTile][kPad] At[jj][ii] = att[i][j]
  float* da_i = At + kTile * kPad; // [kTile]
  float* da_j = da_i + kTile;      // [kTile]
  float* dt_j = da_j + kTile;      // [kTile]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = it * kTile;
  const size_t row0 = (size_t)bc * l;  // first position of the chunk

  // only rows below l do work: at l = 16 three quarters of the warps
  // skip the products (they still help with the copies)
  const bool live = i0 + ty * 4 < l;
  fill_transposed(Cs, Cm + row0 * n, i0, l, n);
  if (tid < kTile) {
    const int i = i0 + tid;
    da_i[tid] = i < l ? dacs[(row0 + i) * h + hh] : 0.f;
  }

  float acc[4][4 * PG];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4 * PG; ++c) acc[a][c] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();  // the previous j tile's Bs, Xs and At are consumed
    fill_transposed(Bs, Bm + row0 * n, j0, l, n);
    for (int e = tid; e < kTile * PW; e += kThreads) {
      const int jj = e / PW, c = e % PW;
      const bool ok = j0 + jj < l && c < p;
      const size_t pos = row0 + (ok ? j0 + jj : 0);
      cp_async4(Xs + e, x + (pos * h + hh) * p + (ok ? c : 0), ok);
    }
    if (tid < kTile) {
      const int j = j0 + tid;
      const bool ok = j < l;
      da_j[tid] = ok ? dacs[(row0 + j) * h + hh] : 0.f;
      dt_j[tid] = ok ? dt[(row0 + j) * h + hh] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    for (int e = tid; e < kTile * PW; e += kThreads) Xs[e] *= dt_j[e / PW];
    __syncthreads();

    if (live) {
      // S = C_i . B_j^T on this thread's 4 x 4: i = ty*4 + a, j = tx*4 + q
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[a][q] = 0.f;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float4 c4 = ld4(Cs + k * kPad + ty * 4);
        const float4 b4 = ld4(Bs + k * kPad + tx * 4);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[a][q] = fmaf(cv[a], bv[q], s[a][q]);
      }

      // decay with the causal mask selected first, stored transposed
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int jj = tx * 4 + q;
        const int j = j0 + jj;
        float v[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int ii = ty * 4 + a;
          const int i = i0 + ii;
          v[a] = (j <= i && i < l) ? s[a][q] * expf(da_i[ii] - da_j[jj])
                                   : 0.f;
        }
        *reinterpret_cast<float4*>(At + jj * kPad + ty * 4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();

    if (live) {
      // y += att @ xdt: rows i = ty*4 + a, columns g*64 + tx*4 + q
      const int jn = min(kTile, l - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const float4 a4 = ld4(At + jj * kPad + ty * 4);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int g = 0; g < PG; ++g) {
          const float4 x4 = ld4(Xs + jj * PW + g * kTile + tx * 4);
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[a][g * 4 + q] = fmaf(av[a], xv[q], acc[a][g * 4 + q]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    if (i >= l) continue;
    float* yrow = y + ((row0 + i) * h + hh) * p;
#pragma unroll
    for (int g = 0; g < PG; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = g * kTile + tx * 4 + q;
        if (c < p) yrow[c] = acc[a][g * 4 + q];
      }
  }
}

// state[hh][p0 .. p0+63][n0 .. n0+63] of chunk bc, reduced over all l.
__device__ void state_tile(const float* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ dacs,
                           const float* __restrict__ Bm,
                           float* __restrict__ st, int bc, int hh, int t,
                           const Dims& d, float* smem) {
  const int l = d.l, h = d.h, p = d.p, n = d.n;
  const int p0 = (t / d.n_ntiles) * kTile;
  const int n0 = (t % d.n_ntiles) * kTile;
  float* Xw = smem;               // [kTile j][kTile]  x * dt * w
  float* Bt = Xw + kTile * kTile; // [kTile j][kTile]  B
  float* dt_s = Bt + kTile * kTile;
  float* w_s = dt_s + kTile;      // exp(dAcs_last - dAcs_j)

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t row0 = (size_t)bc * l;
  const float da_last = dacs[(row0 + l - 1) * h + hh];

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;

  for (int j0 = 0; j0 < l; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int jj = e / kTile, c = e % kTile;
      const bool row = j0 + jj < l;
      const size_t pos = row0 + (row ? j0 + jj : 0);
      const bool xok = row && p0 + c < p, bok = row && n0 + c < n;
      cp_async4(Xw + e, x + (pos * h + hh) * p + (xok ? p0 + c : 0), xok);
      cp_async4(Bt + e, Bm + pos * n + (bok ? n0 + c : 0), bok);
    }
    if (tid < kTile) {
      const int j = j0 + tid;
      float dtv = 0.f, w = 0.f;
      if (j < l) {
        const size_t pos = (row0 + j) * h + hh;
        dtv = dt[pos];
        w = expf(da_last - dacs[pos]);
      }
      dt_s[tid] = dtv;
      w_s[tid] = w;
    }
    cp_async_wait_all();
    __syncthreads();
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int jj = e / kTile;
      Xw[e] = Xw[e] * dt_s[jj] * w_s[jj];
    }
    __syncthreads();
    const int jn = min(kTile, l - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float4 x4 = ld4(Xw + jj * kTile + ty * 4);
      const float4 b4 = ld4(Bt + jj * kTile + tx * 4);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(xv[a], bv[q], acc[a][q]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int pp = p0 + ty * 4 + a;
    if (pp >= p) continue;
    float* srow = st + (((size_t)bc * h + hh) * p + pp) * n;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int nn = n0 + tx * 4 + q;
      if (nn < n) srow[nn] = acc[a][q];
    }
  }
}

// grid (h, n_itiles + state tiles, b * nc); blockIdx.y < n_itiles is a y
// tile (heaviest first), the rest are state tiles.
template <int PG>
__global__ void __launch_bounds__(kThreads)
    ssd_intra_chunk_kernel(const float* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ dacs,
                           const float* __restrict__ Bm,
                           const float* __restrict__ Cm,
                           float* __restrict__ y, float* __restrict__ st,
                           Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int hh = blockIdx.x;
  const int bc = blockIdx.z;
  const int t = blockIdx.y;
  if (t < d.n_itiles)
    y_tile<PG>(x, dt, dacs, Bm, Cm, y, bc, hh, d.n_itiles - 1 - t, d, smem);
  else
    state_tile(x, dt, dacs, Bm, st, bc, hh, t - d.n_itiles, d, smem);
}

template <int PG>
int launch(const float* x, const float* dt, const float* dacs,
           const float* Bm, const float* Cm, float* y, float* st, int bc,
           const Dims& d, cudaStream_t stream) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const size_t most = y_floats(kMaxN, PG) > state_floats()
                            ? y_floats(kMaxN, PG)
                            : state_floats();
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel<PG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(most * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  size_t floats = y_floats(d.n, PG);
  if (state_floats() > floats) floats = state_floats();
  const int n_ptiles = (d.p + kTile - 1) / kTile;
  const dim3 grid(d.h, d.n_itiles + n_ptiles * d.n_ntiles, bc);
  ssd_intra_chunk_kernel<PG><<<grid, dim3(kThreads), floats * sizeof(float),
                               stream>>>(x, dt, dacs, Bm, Cm, y, st, d);
  return (int)cudaGetLastError();
}

}  // namespace

// batch_chunks = b * nc.  Returns 0 on success, a cudaError_t from the
// launch, or -1 for arguments the kernel does not take (empty or too
// large dimensions, p > 128, n > 256).
extern "C" int ssd_intra_chunk_launch(const void* x, const void* dt,
                                      const void* dacs, const void* B,
                                      const void* C, void* y, void* states,
                                      int batch_chunks, int l, int h, int p,
                                      int n, void* stream) {
  if (batch_chunks <= 0 || l <= 0 || h <= 0 || p <= 0 || n <= 0 ||
      p > kMaxP || n > kMaxN || batch_chunks > 65535)
    return -1;
  Dims d;
  d.l = l;
  d.h = h;
  d.p = p;
  d.n = n;
  d.n_itiles = (l + kTile - 1) / kTile;
  d.n_ntiles = (n + kTile - 1) / kTile;
  if (d.n_itiles + ((p + kTile - 1) / kTile) * d.n_ntiles > 65535) return -1;
  const float* xp = static_cast<const float*>(x);
  const float* dtp = static_cast<const float*>(dt);
  const float* dap = static_cast<const float*>(dacs);
  const float* bp = static_cast<const float*>(B);
  const float* cp = static_cast<const float*>(C);
  float* yp = static_cast<float*>(y);
  float* sp = static_cast<float*>(states);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p <= kTile)
    return launch<1>(xp, dtp, dap, bp, cp, yp, sp, batch_chunks, d, s);
  return launch<2>(xp, dtp, dap, bp, cp, yp, sp, batch_chunks, d, s);
}
