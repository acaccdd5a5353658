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
// Bound: operations, on the route this kernel takes.  The function needs,
// per (b, c), the causal half of C.B^T (l(l+1)/2 * n multiply-adds,
// shared by the heads), and per head the causal half of att @ xdt
// (l(l+1)/2 * p) and the state product (l * p * n).  At mamba2-780m's
// 256-token chunk (h 48, p 64, n 128) that is ~0.41 GFLOP against ~8.2 MB
// of inputs and outputs (2.5 us at 3.35 TB/s).  Every product runs on the
// tensor cores in 3xTF32, three TF32 products per float32 one, so the
// route's peak is 495 / 3 = 165 TFLOP/s: a bound of 2.5 us (the bytes
// and the operations meet there).  On the CUDA cores (FFMA, 67 TFLOP/s)
// the same work would take at least 6.1 us.
//
// Why the products are split: TF32 keeps 10 bits of mantissa (~3 decimal
// digits), and the reference's tests hold this kernel to 1e-4 relative
// and 1e-5 of the largest output; one TF32 product per float32 one lands
// 15-28 times outside those limits at the full models' chunks
// (tests/test_torch_ssd.py).  Each operand a is written as big = tf32(a),
// rounded to nearest with ties away from zero (cvt.rna's rounding), plus
// small = a - big, and a product as small.big + big.small + big.big,
// issued in that order into one float32 accumulator: what is dropped
// (small.small, and the bits of small past TF32) is ~2^-21 of the
// product, near float32's own 2^-24.  The tensor core's own float32
// accumulation loses more than that over a long sum (it does not round
// to nearest as an FADD does): accumulating all k steps in it left y
// several times farther from a float64 reference than the plain float32
// version.  So each k step's three products go into a fresh accumulator,
// added to the running sum with an ordinary float32 add: y then lands as
// near float64 as the plain float32 version does (~2e-7 relative L2,
// benchmarks/ssd_readings.py).
//
// What the design does about it:
// * The TPU kernel keeps a whole l x l score matrix of one (b, c, h) in
//   VMEM.  At l = 256 that is 256 KB of float32, more than an SM's shared
//   memory.  Here one CTA (8 warps) takes one (b, c, 64-row tile of i)
//   for a group of G heads and streams the 64-column tiles of j up to the
//   diagonal only (causal).  Each warp owns a 16-row by 32-column part of
//   the S = C_i . B_j^T tile and 16-row parts of the G heads' y
//   accumulators, in mma.sync m16n8k8 TF32 fragments with float32
//   accumulators.  S is computed once per j tile and used by the G heads
//   in turn: its decayed copy (times dt_j) goes through shared memory
//   once per head (the accumulator's fragment is not the A operand's)
//   and is multiplied by the head's x tile.  On the diagonal tile a warp
//   skips the S columns and the j steps past its last row.
// * G is chosen at launch from b * nc, l, h, p and n, never by the
//   caller: 1 where G = 2 would leave fewer than two y tiles per SM (the
//   main path's chunk prefills, b * nc = 1), 2 where the grid is large
//   (the hybrid model's long prefill, b * nc = 64) and two CTAs of two
//   heads still fit an SM.
// * The decay exp(dAcs_i - dAcs_j) is selected on j <= i *before* the
//   exp: above the diagonal the exponent is positive and can overflow,
//   and inf * 0 would be NaN.  Both selects are branch-free (selp), so a
//   thread's sixteen decays run side by side.  Every exp is expf, as
//   torch.exp computes it: the fast __expf loses ~1.2 ulp per unit of
//   |x|, and dAcs_i - dAcs_j reaches hundreds in a 256-position chunk
//   (steps dt * A with A up to 16).
// * The products run 3xTF32 throughout: per k step a warp splits its
//   fragments in registers and issues the small.big, big.small and
//   big.big products of four accumulators in turn, so that dependent
//   products are four apart.  The split rounds with two integer
//   instructions: the compiler expands cvt.rna.tf32 into several, and
//   the splits, not the tensor core, bounded the first version.
// * Copies are asynchronous and come in groups that overlap the
//   products: the next B tile lands while the heads' products run, the
//   next x tiles while S runs.  Every operand sits in shared memory in
//   the row-major layout device memory has (C and B rows of n floats, x
//   rows of p floats), filled with 16-byte cp.async.cg copies where rows
//   are 16-byte aligned (n and p multiples of 4; 4-byte copies
//   otherwise).  No tile is transposed: the fragment loads index the
//   layouts they need, and row strides are padded so that a warp's
//   fragment load hits 32 distinct banks.  Tiles are filled only as far
//   as l reaches, rounded up to 16 rows (at l = 16, 16 rows, not 64).
// * The state products (p x n, reduced over l) run in 64 x 64 tiles,
//   extra CTAs of the same grid (blockIdx.y past the i tiles), issued
//   after the y tiles.  At l <= 64 they run beside the chunk's one y
//   tile: writing the states from the y tile's CTA, which holds x and B
//   already, was slower at l = 16 and 64 (benchmarks/ssd_readings.py).
// * Warps whose 16 rows all lie at or past l skip the products (at
//   l = 16, six of eight).
//
// ssd_empty_launch launches an empty kernel through the same C path: the
// floor that any kernel of this library reads in a timing harness.
//
// The C entries launch on the caller's stream and return
// cudaGetLastError(); they allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: warp w has row group w % 4,
                               // column half w / 4
constexpr int kTile = 64;      // rows and columns of every tile
constexpr int kAtLd = kTile + 4;  // row stride of the score tile, floats
constexpr int kMaxP = 128;     // head_dim: at most two 64-column groups
constexpr int kMaxN = 256;     // ssm_state

struct Dims {
  int l, h, p, n;
  int kn;        // n rounded up to the mma depth (8)
  int ldk;       // row stride of the C and B tiles: n rounded to 32, + 4
  int n_itiles;  // y tiles per (b, c, head)
  int n_ptiles;  // state tiles along p
  int n_ntiles;  // state tiles along n
  int vx, vb;    // 16-byte copies for x rows / B and C rows
};

__host__ __device__ inline int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

// Asynchronous copies global -> shared; zero-fill when !valid (src-size
// 0: nothing is read, `src` only has to be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// dst[r * ld + c] = src[r * stride + c] for r < rows and c < cols, zero
// for rows <= r < R and cols <= c < width.  With vec, every copy is 16
// bytes (cols, stride and width multiples of 4, src 16-byte aligned).
// The copies are asynchronous: every thread issues all of its copies
// before any of them has to land (cp_async_wait).
__device__ __forceinline__ void fill_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          size_t stride, int R, int rows,
                                          int cols, int width, bool vec) {
  const int step = vec ? 4 : 1;
  const int w = width / step;  // copies per row
  int r = threadIdx.x / w, c = threadIdx.x % w;
  const int dr = kThreads / w, dc = kThreads % w;
  while (r < R) {
    const int cc = c * step;
    const bool ok = r < rows && cc < cols;
    const float* from = ok ? src + r * stride + cc : src;
    if (vec)
      cp_async16(dst + r * ld + cc, from, ok);
    else
      cp_async4(dst + r * ld + cc, from, ok);
    c += dc;
    r += dr;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

// --- 3xTF32 tensor-core products -------------------------------------
// m16n8k8 fragments (lane = 4 g + t): A (16 x 8, row-major) a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8, k by n)
// b0 (t, g), b1 (t + 4, g); C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1),
// c2 (g + 8, 2t), c3 (g + 8, 2t + 1).

// a = big + small: big = tf32(a), rounded to nearest with ties away from
// zero (cvt.rna's rounding, done as two integer instructions, where the
// compiler expands cvt.rna.tf32 into several), and small = a - big, exact
// in float32, of which the tensor core reads the TF32 part.  A NaN in a
// stays NaN in small.
__device__ __forceinline__ void split_tf32(float a, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(a - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's acc[q] += A (16 x kend) . B (kend x 8) for the NT n8 tiles q
// of B, in 3xTF32: per k step small.big, big.small, big.big into a fresh
// accumulator per tile, issued tile by tile (four tiles at a time) so
// that the dependent products of one accumulator are four apart, then
// added to acc[q] with an ordinary float32 add.  A's element (m, k) is A[m * am + k * ak],
// times u[k] * v[k] (rounded in that order) when SCALED; B's (k, n) is
// B[k * bk + n * bn], tile q starting at column 8 q.  kend is a multiple
// of 8.
template <int NT, bool SCALED = false>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* A,
                                         int am, int ak, const float* B,
                                         int bk, int bn, int kend,
                                         const float* u = nullptr,
                                         const float* v = nullptr) {
  constexpr int NC = NT < 4 ? NT : 4;
  static_assert(NT % NC == 0, "B tiles in groups of four");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = A + g * am + t * ak;
  const float* b0 = B + t * bk + g * bn;
#pragma unroll 2
  for (int k0 = 0; k0 < kend; k0 += 8) {
    const float* a = a0 + k0 * ak;
    float av[4] = {a[0], a[8 * am], a[4 * ak], a[8 * am + 4 * ak]};
    if (SCALED) {
      const float s0 = u[k0 + t], s1 = v[k0 + t];
      const float s2 = u[k0 + t + 4], s3 = v[k0 + t + 4];
      av[0] = av[0] * s0 * s1;
      av[1] = av[1] * s0 * s1;
      av[2] = av[2] * s2 * s3;
      av[3] = av[3] * s2 * s3;
    }
    uint32_t ab[4], as[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(av[e], ab[e], as[e]);
    const float* b = b0 + k0 * bk;
    // B tiles four at a time: their split halves stay in 16 registers
#pragma unroll
    for (int q0 = 0; q0 < NT; q0 += NC) {
      uint32_t bb[NC][2], bs[NC][2];
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        split_tf32(b[(q0 + q) * 8 * bn], bb[q][0], bs[q][0]);
        split_tf32(b[(q0 + q) * 8 * bn + 4 * bk], bb[q][1], bs[q][1]);
      }
      float part[NC][4];
#pragma unroll
      for (int q = 0; q < NC; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[q][e] = 0.f;
#pragma unroll
      for (int q = 0; q < NC; ++q) mma_tf32(part[q], as, bb[q]);
#pragma unroll
      for (int q = 0; q < NC; ++q) mma_tf32(part[q], ab, bs[q]);
#pragma unroll
      for (int q = 0; q < NC; ++q) mma_tf32(part[q], ab, bb[q]);
#pragma unroll
      for (int q = 0; q < NC; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q0 + q][e] += part[q][e];
    }
  }
}

// p ? a : b without a branch: both sides are computed, and the one not
// taken never reaches the result (inf * 0 included).
__device__ __forceinline__ float select(bool p, float a, float b) {
  float r;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %3, 0;\n selp.f32 %0, %1, %2, q;\n}\n"
      : "=f"(r)
      : "f"(a), "f"(b), "r"((unsigned)p));
  return r;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory floats of a y tile of G heads and of a state tile; the
// launch takes the larger.
__host__ __device__ inline int x_ld(int pg) { return pg * kTile + 8; }
__host__ __device__ inline size_t y_floats(int ldk, int pg, int g) {
  return (size_t)2 * kTile * ldk + (size_t)g * kTile * x_ld(pg) +
         (size_t)kTile * kAtLd + (size_t)3 * g * kTile;
}
__host__ __device__ inline size_t state_floats() {
  return (size_t)2 * kTile * x_ld(1) + 2 * kTile;
}

// y rows i0 .. i0+63 of heads h0 .. h0+G-1 of chunk bc (heads at or past
// h are skipped).  PG = 64-column groups of p.
template <int PG, int G>
__device__ void y_tile(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ dacs,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm, float* __restrict__ y,
                       int bc, int h0, int it, const Dims& d, float* smem) {
  constexpr int PW = PG * kTile;   // columns of an x tile
  constexpr int XLD = PW + 8;      // its row stride
  constexpr int NQ = PW / 16;      // n8 tiles of a warp's y columns
  const int l = d.l, h = d.h, p = d.p, n = d.n, ldk = d.ldk;
  const int nh = min(G, h - h0);   // heads of this group
  float* Cs = smem;                // [kTile][ldk]  Cs[ii][k] = C[i0+ii][k]
  float* Bs = Cs + kTile * ldk;    // [kTile][ldk]  Bs[jj][k] = B[j0+jj][k]
  float* Xs = Bs + kTile * ldk;    // [G][kTile][XLD]  x[j][h0+g][:]
  float* At = Xs + G * kTile * XLD;  // [kTile][kAtLd]  att of one head
  float* da_i = At + kTile * kAtLd;  // [G][kTile]
  float* da_j = da_i + G * kTile;  // [G][kTile]
  float* dt_j = da_j + G * kTile;  // [G][kTile]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;
  const int i0 = it * kTile;
  const size_t row0 = (size_t)bc * l;  // first position of the chunk

  // rows of the tile that exist, rounded up to a warp's 16
  const int ri = min(kTile, round_up(l - i0, 16));
  const bool live = rg * 16 < ri;
  // the copies come in groups: C with the first B tile, then per j tile
  // its x tiles, and the next B tile once S has read this one
  fill_rows(Cs, ldk, Cm + (row0 + i0) * n, n, ri, l - i0, n, d.kn, d.vb);
  fill_rows(Bs, ldk, Bm + row0 * n, n, min(kTile, round_up(l, 16)),
            min(kTile, l), n, d.kn, d.vb);
  cp_async_commit();
  for (int e = tid; e < G * kTile; e += kThreads) {
    const int g = e / kTile, i = i0 + e % kTile;
    da_i[e] = g < nh && i < l ? dacs[(row0 + i) * h + h0 + g] : 0.f;
  }

  float acc[G][NQ][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][q][e] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    const int jn = min(kTile, l - j0);
    const int rj = min(kTile, round_up(jn, 16));
    const bool diag = jt == it;
    // x tiles (and dt, dAcs) of this j tile: free since the last head's
    // product of the previous tile
    for (int g = 0; g < nh; ++g)
      fill_rows(Xs + g * kTile * XLD, XLD,
                x + ((row0 + j0) * h + h0 + g) * p, (size_t)h * p, rj, jn, p,
                PW, d.vx);
    for (int e = tid; e < G * kTile; e += kThreads) {
      const int g = e / kTile, jj = e % kTile;
      const bool ok = g < nh && jj < jn;
      const size_t pos = ok ? (row0 + j0 + jj) * h + h0 + g : 0;
      cp_async4(da_j + e, dacs + pos, ok);
      cp_async4(dt_j + e, dt + pos, ok);
    }
    cp_async_commit();
    cp_async_wait<1>();  // C and this B tile have landed
    __syncthreads();

    // S on this warp's 16 rows x 32 columns; on the diagonal a warp
    // whose columns all lie past its last row skips it (all masked)
    const int cmax = diag ? min(rj, rg * 16 + 16) : rj;
    float s[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[q][e] = 0.f;
    if (live && cg * 32 < cmax)
      warp_mma<4>(s, Cs + rg * 16 * ldk, ldk, 1, Bs + cg * 32 * ldk, 1, ldk,
                  d.kn);
    __syncthreads();  // S has read Bs: the next B tile may land there
    if (!diag) {
      const int jn1 = min(kTile, l - j0 - kTile);
      fill_rows(Bs, ldk, Bm + (row0 + j0 + kTile) * n, n,
                min(kTile, round_up(jn1, 16)), jn1, n, d.kn, d.vb);
    }
    cp_async_commit();
    cp_async_wait<1>();  // the x tiles have landed
    __syncthreads();

#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= nh) break;
      const float* dai = da_i + g * kTile;
      const float* daj = da_j + g * kTile;
      const float* dtj = dt_j + g * kTile;
      if (live) {
        // the decay with the causal mask selected first, times dt_j
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int jj = cg * 32 + q * 8 + 2 * t4;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int ii = rg * 16 + g8 + half * 8;
            const int i = i0 + ii;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool ok = j0 + jj + e <= i && i < l;
              const float xe = select(ok, dai[ii] - daj[jj + e], 0.f);
              v[e] = select(ok, s[q][half * 2 + e] * expf(xe) * dtj[jj + e],
                            0.f);
            }
            *reinterpret_cast<float2*>(At + ii * kAtLd + jj) =
                make_float2(v[0], v[1]);
          }
        }
      }
      __syncthreads();
      if (live) {
        // y += att @ x on rows 16 rg .., columns cg * PW / 2 ..
        const int kmax = round_up(diag ? min(jn, rg * 16 + 16) : jn, 8);
        warp_mma<NQ>(acc[g], At + rg * 16 * kAtLd, kAtLd, 1,
                     Xs + g * kTile * XLD + cg * (PW / 2), XLD, 1, kmax);
      }
      __syncthreads();  // At (and, after the last head, Xs) consumed
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= nh) break;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + rg * 16 + g8 + half * 8;
        if (i >= l) continue;
        float* yrow = y + ((row0 + i) * h + h0 + g) * p;
        const int c = cg * (PW / 2) + q * 8 + 2 * t4;
        if (c < p) yrow[c] = acc[g][q][half * 2];
        if (c + 1 < p) yrow[c + 1] = acc[g][q][half * 2 + 1];
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
  constexpr int LD = kTile + 8;
  const int l = d.l, h = d.h, p = d.p, n = d.n;
  const int p0 = (t / d.n_ntiles) * kTile;
  const int n0 = (t % d.n_ntiles) * kTile;
  float* Xw = smem;              // [kTile j][LD]  x * dt * w, columns p0 ..
  float* Bt = Xw + kTile * LD;   // [kTile j][LD]  B, columns n0 ..
  float* dt_s = Bt + kTile * LD;
  float* w_s = dt_s + kTile;     // exp(dAcs_last - dAcs_j)

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;
  const size_t row0 = (size_t)bc * l;
  const float da_last = dacs[(row0 + l - 1) * h + hh];

  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;

  for (int j0 = 0; j0 < l; j0 += kTile) {
    const int jn = min(kTile, l - j0);
    const int rj = min(kTile, round_up(jn, 16));
    __syncthreads();  // the previous tile is consumed
    fill_rows(Xw, LD, x + ((row0 + j0) * h + hh) * p + p0, (size_t)h * p, rj,
              jn, min(kTile, p - p0), kTile, d.vx);
    fill_rows(Bt, LD, Bm + (row0 + j0) * n + n0, n, rj, jn,
              min(kTile, n - n0), kTile, d.vb);
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
    // state rows p = 16 rg .., columns n = 32 cg ..; A (p, j) = x * dt * w
    const int kmax = round_up(jn, 8);
    warp_mma<4, true>(acc, Xw + rg * 16, 1, LD, Bt + cg * 32, LD, 1, kmax,
                      dt_s, w_s);
  }

#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pp = p0 + rg * 16 + g + half * 8;
      if (pp >= p) continue;
      float* srow = st + (((size_t)bc * h + hh) * p + pp) * n;
      const int nn = n0 + cg * 32 + q * 8 + 2 * tq;
      if (nn < n) srow[nn] = acc[q][half * 2];
      if (nn + 1 < n) srow[nn + 1] = acc[q][half * 2 + 1];
    }
}

// grid (head groups, n_itiles + state tiles, b * nc).  blockIdx.y <
// n_itiles is a y tile of G heads (heaviest first); past them come the
// state tiles of each head of the group.
template <int PG, int G>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_intra_chunk_kernel(const float* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ dacs,
                           const float* __restrict__ Bm,
                           const float* __restrict__ Cm,
                           float* __restrict__ y, float* __restrict__ st,
                           Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int h0 = blockIdx.x * G;
  const int bc = blockIdx.z;
  const int t = blockIdx.y;
  if (t < d.n_itiles) {
    y_tile<PG, G>(x, dt, dacs, Bm, Cm, y, bc, h0, d.n_itiles - 1 - t, d,
                  smem);
    return;
  }
  const int per_head = d.n_ptiles * d.n_ntiles;
  const int hh = h0 + (t - d.n_itiles) / per_head;
  if (hh < d.h)
    state_tile(x, dt, dacs, Bm, st, bc, hh, (t - d.n_itiles) % per_head, d,
               smem);
}

// Shared memory one CTA may hold for two to fit an SM (228 KB, 1 KB of it
// reserved per CTA).
constexpr size_t kTwoPerSm = 115 * 1024;

template <int PG, int G>
int launch(const float* x, const float* dt, const float* dacs,
           const float* Bm, const float* Cm, float* y, float* st, int bc,
           const Dims& d, cudaStream_t stream) {
  static size_t configured = 0;  // the attribute, raised as shapes need
  size_t floats = y_floats(d.ldk, PG, G);
  if (state_floats() > floats) floats = state_floats();
  const size_t bytes = floats * sizeof(float);
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel<PG, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = bytes;
  }
  const int groups = (d.h + G - 1) / G;
  const dim3 grid(groups, d.n_itiles + G * d.n_ptiles * d.n_ntiles, bc);
  ssd_intra_chunk_kernel<PG, G><<<grid, dim3(kThreads), bytes, stream>>>(
      x, dt, dacs, Bm, Cm, y, st, d);
  return (int)cudaGetLastError();
}

// Heads per CTA (p <= 64), from the shapes: 2 where a y tile of two heads
// still fits two CTAs an SM and the grid keeps at least two y tiles per
// SM, otherwise 1.  Sharing S halves its work but runs two heads'
// products in one CTA, which only pays where the grid is large.  (At
// p = 128 two heads' accumulators would spill past the 128 registers a
// thread that two CTAs an SM allow.)
int heads_per_cta(const Dims& d, int bc, int sms) {
  const size_t bytes = y_floats(d.ldk, 1, 2) * sizeof(float);
  const long tiles = (long)((d.h + 1) / 2) * d.n_itiles * bc;
  return bytes <= kTwoPerSm && tiles >= 2L * sms ? 2 : 1;
}

__global__ void ssd_empty_kernel() {}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
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
  static int sms = 0;  // the card's SM count, read once
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  Dims d;
  d.l = l;
  d.h = h;
  d.p = p;
  d.n = n;
  d.kn = round_up(n, 8);
  d.ldk = round_up(n, 32) + 4;
  d.n_itiles = (l + kTile - 1) / kTile;
  d.n_ptiles = (p + kTile - 1) / kTile;
  d.n_ntiles = (n + kTile - 1) / kTile;
  d.vx = p % 4 == 0 && aligned16(x);
  d.vb = n % 4 == 0 && aligned16(B) && aligned16(C);
  if (d.n_itiles + 2 * d.n_ptiles * d.n_ntiles > 65535) return -1;
  const float* xp = static_cast<const float*>(x);
  const float* dtp = static_cast<const float*>(dt);
  const float* dap = static_cast<const float*>(dacs);
  const float* bp = static_cast<const float*>(B);
  const float* cp = static_cast<const float*>(C);
  float* yp = static_cast<float*>(y);
  float* sp = static_cast<float*>(states);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p > kTile)
    return launch<2, 1>(xp, dtp, dap, bp, cp, yp, sp, batch_chunks, d, s);
  if (heads_per_cta(d, batch_chunks, sms) == 2)
    return launch<1, 2>(xp, dtp, dap, bp, cp, yp, sp, batch_chunks, d, s);
  return launch<1, 1>(xp, dtp, dap, bp, cp, yp, sp, batch_chunks, d, s);
}

// One empty kernel of one warp on the caller's stream.

extern "C" int ssd_empty_launch(void* stream) {
  ssd_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
